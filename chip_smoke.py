#!/usr/bin/env python3
"""Drive the PyTorch/Hopper port's main path on one GPU and check it.

    python3 chip_smoke.py

Phases (each prints its own lines):

1. device  -- the card's name and power limit, as nvidia-smi reports them;
2. build   -- compile ``src/repro_torch/kernels/csrc/*.cu`` (or find them
              built) into ``build/repro_torch_kernels/``; the library's SASS
              (``cuobjdump``) must show HMMA in every bf16 tensor-core GEMM,
              IMMA in every W8A8 conv and GEMM instance, and no bf16
              instance of the CUDA-core GEMMs; registers a thread of every
              f32 / INT8 GEMM instance (scheme x tile x layout), the ring
              instances at most 8 above the same tile at depth 1;
3. kernels -- each CUDA kernel against its plain PyTorch version on the card,
              at the main path's shapes and ragged ones, the INT8 schemes of
              the conv kernel and both schemes of the quant matmul included,
              the pipelined (K-slab ring) GEMMs at depth 2 and 3 also
              ``torch.equal`` to the tiled kernel, and every tile of each
              kernel family once (``torch.equal`` to the default tile; the
              bf16 GEMM's own tile list on a prefill and an odd-K case);
              the 1x1-conv path through ``ops.conv2d`` in the GEMMs' NCHW
              layout (super resolution's expand in f32 and W8, coloring's
              1x1 in W8A8): ``torch.equal`` to the row-major kernel
              permuted, one device kernel a call for f32 / W8, every tile
              and depth equal, ``F.conv2d`` (TF32 off) as the library;
              every GEMM shape the decoder plans launch, at decode and
              prefill, with a sum of their device ms per plan call (for
              qwen2.5-3b, granite-3-2b and phi4-mini-3.8b: q, k/v, o, down,
              gate/up and flash -- split-KV at decode for d64 H32/G8 and
              d128 H24/G8, tensor cores at prefill S = 48):
              max error; device ms per call (profiler kernel time, or CUDA
              events where no profiler session saw device time) of the
              kernel, the plain version and the library call; the kernel's
              per-call time as the stream sees it (``call_ms``, host launch
              overhead included); and the least time the card could take
              (bytes over 3.35 TB/s, or operations over 67 TFLOP/s for f32
              -- the H100 SXM's memory rate and f32 CUDA-core peak -- over
              989 TFLOP/s for bf16, or over 1,979 TOP/s for int8, its
              tensor-core peaks; the block-sparse kernel's cases count the
              real blocks' bytes and operations); each bsr_matmul and
              flash_attention case prints its route (every flash route is
              launched), each W8A8 conv case whether it is torch.equal to
              the plain version;
4. apps    -- the paper's pipeline for each demo app at full width (base 32):
              build from a seeded ``torch.Generator``, prune with
              ``app_masks``, compile with ``PassManager`` + ``compile_plan``,
              serve 10 frames of 256x256 through ``PlanServer(batch_size=4)``;
              checks the node count, the exact kernel launches per plan call,
              zero conv fallbacks, and the output against the reference plan;
              then profiles one more serving run (device time per kernel
              family and the device's idle share);
5. int8    -- the same apps through the INT8 path: calibrate on the f32
              reference plan (2 random batches), run the ``quantize`` pass
              with the app's skip sets, compile for the ``quant`` backend and
              serve as in phase 4; checks the quantized nodes' schemes, the
              exact launches per plan call (conv kernel by scheme,
              quant_matmul, dense_matmul, fused_elementwise), zero conv
              fallbacks, every quantized step's kernel handler against its
              reference handler on the same inputs, and the whole plan
              against the quant reference plan; prints the error against the
              f32 plan, the weight bytes before and after, ms/frame beside
              the f32 plan's, and a profile line;
5b. profile -- ``profile_plan`` on each app's f32 and INT8 plan (one
              batch of 4): rows equal to the plan's steps, host ms and
              device ms per plan call and the top 5 steps by each, and the
              summed step device ms of one more profiled call within 0.8-1.2
              of the card's time torch.profiler sees in it (its kernels and
              the idle between consecutive kernels; the ratio to the
              kernels alone is printed), no gap between two kernels of a
              timed window above 50 us; a guarded plan reports no device
              ms; ``launch/profile`` on super resolution; then ``serve
              --async --metrics-dump`` through the CLI's ``main`` (snapshot
              file and Chrome trace);
6. serve async -- the frame side of ``AsyncPlanServer`` and the guarded
              backend, on phases 4-5's plans at full width, 24 frames an
              app to each of its plans: (1) zero faults, the f32 and INT8
              plans of every app in one server with tenants
              ``gold:3:200,free:1:50``: every submit gets a verdict
              (completed + throttled + shed = submits), every output
              ``torch.equal`` to the plan run again on the batch the
              scheduler formed, per-tenant p50/p95/p99, ms/frame, a profile
              line (no tenants); (2) guarded plans: at 0% faults no demotion,
              every chunk ``torch.equal`` to the kernel plans, ms/frame
              beside theirs (kernel, guarded, guarded, kernel); at 100%
              ``raise`` every chunk ``torch.equal`` to the reference plans
              with demotions = demotable steps x calls; breakers trip and
              close after the cooldown on an injected clock; at a seeded 5%
              every request within its tolerance of the reference plan and
              demotions = injections; (3) ``cache_corrupt``: every kernel
              plan raises ``TileError``, every guarded plan demotes each
              kernel step and is ``torch.equal`` to the reference plan, the
              cache is cleared; (4) ``swap_plan`` f32 -> INT8 under load
              with zero loss and the old versions retired, a NaN version
              rolled back, and a 1 s latency fault under a 0.5 s watchdog
              failing its batch only; then guarded decode at the smoke
              config through ``submit_llm``: the kernel plans' tokens at
              0% faults, the reference plans' at 100%, no failed sequence or
              leaked page, ms per decode step of each;
7. tune    -- the port's ``launch/tune`` for the three apps with
              ``--quantize`` at the served shapes (every key ``|sm90``,
              every ``matmul`` / ``qmatmul`` / ``conv2d`` key swept), then
              each app's f32 and INT8 plans served on the loaded winners
              (outputs ``torch.equal`` to the untuned plans', no cache
              misses, tuned against untuned ms/frame), then with every
              ``matmul`` / ``qmatmul`` entry replaced by a depth-2 and a
              depth-3 tile: exact pipelined-kernel launches per plan call,
              no tiled launch for those nodes, outputs equal again; the
              cache is cleared and tuning turned off after it (every earlier
              phase runs with tuning off and an empty cache);
8. llm smoke -- the decoder's ``serve --llm`` path at qwen2.5-3b's smoke
              config in f32 (prefill / decode plans, ``submit_llm`` over a
              paged KV-cache; exact launches per plan call, zero failed
              sequences and leaked pages, exact greedy parity with the
              plain ``forward``), then the same params block-pruned on
              every q / o projection with ``Block(0.5, 32, 32,
              balanced=False)`` (bands, unperm glue and a standalone rope
              on the card; exact parity against ``forward`` on the masked
              params);
9. llm      -- qwen2.5-3b at full width in bf16, as phase 7 (greedy parity
              up to the first bf16 near-tie, teacher-forced within 8 bf16
              ulps); each llm phase prints flash_attention's device ms a
              prefill and a decode plan call of its profiled run; phase 9
              also serves its graphs compiled ``guarded`` and ``reference``,
              as phase 6 does the smoke decoder's, and profiles one prefill
              and one decode plan call as phase 5b does the apps';
10. llm block-pruned -- phase 8's params pruned with the paper's attention
              recipe ``Block(0.5, 64, 64)`` on q / o and served again,
              the dense model released first: 72 ``bsr_matmul`` and 108
              bf16 ``dense_matmul`` launches per plan call, the packed q /
              o bytes at most half the dense ones, the plans' params and
              peak allocated below the dense ones, teacher-forced parity
              against ``forward`` on the masked params;
11. llm granite-3-2b, llm phi4-mini-3.8b -- phase 9 at full width in bf16
              for the two other decoders (head dim 64 with 4 query heads a
              KV group and tied embeddings; head dim 128 with 3 a group and
              a 200064-word vocab), each model released before the next;
              no guarded or pruned repeat (qwen2.5-3b covers those);
12. serve forward -- the serve CLI's default path (``get_model`` +
              ``Engine`` + ``--scheduler``) at its defaults on
              phi4-mini-3.8b at full width: greedy parity of the generated
              row and of every request the scheduler returns against the
              plain ``forward``.
12b. zoo smoke -- all ten archs' smoke configs (f32) through ``get_model``
              on the card against the same params on the CPU: prefill
              logits, 4 decode steps and ``loss`` within 1e-3 x max(1,
              max|cpu|), ``Engine`` greedy tokens equal (whisper: ``encode``,
              ``decode_train``, ``precompute_cross_kv`` and 4
              ``decode_step``s);
12c. zoo  -- qwen3-14b, deepseek-v2-lite-16b, recurrentgemma-9b,
              paligemma-3b (256 patch embeddings a row), mamba2-1.3b and
              whisper-small at full width in bf16, each model released
              before the next: seeded init on the card, ``Engine`` over the
              JAX CLI's traffic (3 prompts of 16 tokens padded to batch 4,
              12 new tokens), finite logits, greedy parity of the 3 rows
              against the teacher-forced ``forward`` up to the first bf16
              near-tie (mamba2's on f32 weights; none for MoE deepseek,
              whose forward drops other token-slots), a 2x oversubscribed
              ``RequestScheduler`` with no failed request; mamba2's chunked
              prefill against the step recurrence (f32); whisper's
              ``decode_step`` tokens against ``decode_train``; params GB,
              peak allocated, ms / prefill, ms / decode step and tok/s
              (CUDA-synchronised), device busy / idle and the top kernel
              families (torch.profiler).  No kernel of the port launches in
              12b-12c (checked): the JAX package runs these families in
              plain jnp;
13. train smoke -- ``launch.train``'s ADMM -> hard prune -> masked
              pipeline on the smoke qwen2.5-3b in f32 (10 steps of 8 x 32
              tokens: 6 ADMM with 3 Z/U updates, 4 masked), on the card and
              on the CPU from the same params: losses within 1e-3 relative
              step by step, the same update steps, hard-prune masks
              ``torch.equal``; then ``CheckpointManager`` save -> restore ->
              resume on the card (restored state ``torch.equal`` to the
              saved one, resumed losses within 1e-5 of uninterrupted ones);
14. train  -- the same pipeline on qwen2.5-3b at full width in bf16, batch
              8 x seq 128 (the JAX launcher's defaults): finite losses and
              grad norms, Z/U updates where the JAX condition holds, rho on
              its ramp, the hard prune's sparsity within 0.05 of 0.5, Block
              masks constant on 64 x 64 tiles and Column masks along rows,
              masks unchanged by the fine-tune; ms per ADMM / masked step
              and per Z/U update, tokens/s, model-FLOPs utilization and peak
              allocated per phase; then the hand-off: ``apply_masks(params,
              masks)`` with the hard prune's q / o masks through
              ``optimize`` (no re-projection) into the kernel plans, served
              as phase 10 (72 ``bsr_matmul`` + 108 bf16 ``dense_matmul``
              launches per plan call, greedy parity against ``forward`` on
              the masked params).  Training runs plain autograd (no kernel
              of the port), as the JAX package trains with plain XLA;
15. train profile -- a second short full-width run (fresh params) with
              torch.profiler around one ADMM step with a Z/U update, one
              without and one masked step: device ms and idle share of
              each, device ms by kernel family and by part of the step
              (forward, penalty, backward, AdamW, Z/U update, convergence
              metrics, gradient masks);
16. train zoo -- ``launch.train.train`` on the other families at the JAX
              configs' widths in bf16 (6 steps of 8 x 128 tokens, ``--prune
              --sparsity 0.5 --admm-every 2 --hard-prune-at 0.5``: 4 ADMM
              steps, 2 masked), each model released before the next:
              paligemma-3b (256 patch embeddings a row), mamba2-1.3b and
              whisper-small (1500 frames) at full depth, deepseek-v2-lite-16b
              at 6 of 27 layers, recurrentgemma-9b at 9 of 38 and qwen3-14b
              at 6 of 40 (the cuts where the training state does not fit
              one card; the header line names each): finite losses and grad
              norms, JAX's Z/U condition, ``pruned_global`` within 0.05 of
              0.5 (mamba2: 0, the recipe matches none of its leaves), no
              expert stack pruned, masks unchanged by the fine-tune and
              ``apply_masks`` zero where they are, for MoE a finite aux in
              the loss as ``router_aux_weight x aux``; ms per ADMM / masked
              step, tokens/s, model-FLOPs utilization from the active
              parameters (``utils.flops``) and peak allocated per phase;
17. train remat -- whisper-small at full width, batch 8: one loss + backward
              with ``remat=False`` and one with ``remat=True``: gradients
              within 1e-3 x max(1, max|g|) of each other, the remat peak
              below the other (both printed).  No kernel of the port
              launches in 16-17 (checked).
18. mesh   -- the mesh modules on ``torch.cuda.device_count()`` ranks with
              NCCL, one card a rank (NCCL takes no two ranks on one card:
              on one card the world is 1 and the collectives are trivial),
              a ``(data, model)`` mesh of (1, 1) / (1, 2) / (2, 2) / (2, 4)
              for 1 / 2 / 4 / 8 cards: three steps of qwen2.5-3b's bf16
              train step at full width (8 x 128 tokens, ``DEFAULT_RULES``,
              ZeRO-1 moments) sharded, their losses ``torch.equal`` to the
              unsharded step's on one card (else within 1e-3), ms a step,
              peak GB a rank and the collectives of one forward + backward
              (``CommDebugMode``); the paper's ADMM recipe on the same
              model (``default_prune_plan(0.5)``, ``update_every=2``, 3
              steps, ``hard_prune``, one masked step) unsharded then
              sharded, Z and U placed like the params: losses ``torch.equal``
              on one card (else within 1e-3), the masks ``torch.equal``,
              one Z/U update each, U's local shape the weight's, ms a
              step, the Z/U update's ms and peak GB a rank;
              deepseek-v2-lite-16b at full width (6 of 27 layers, bf16, 8 x
              128 tokens) under ``FSDP_RULES``: three train steps unsharded
              then sharded (the expert stacks cut over ``data`` too; losses
              ``torch.equal`` on one card, else within 1e-3; ms a step, peak
              GB a rank; deterministic algorithms on, as the dispatch's
              gather backward sums with atomics otherwise), then a prefill
              of 16 tokens into 64 slots unsharded and on the sharded
              params with the prompt cut over the batch (logits and every
              cache leaf ``torch.equal`` on one card, every leaf in the
              placements and local shape ``sharding.cache_pspecs`` gives
              it, ms of each), and three decode steps from each one's
              caches (logits ``torch.equal`` on one card, every cache leaf
              in its placements after each step, ms a step); the same
              train, prefill and decode rows for mamba2-1.3b at full width
              (every layer, bf16) under ``DEFAULT_RULES``, its Mamba-2
              mixers tensor-parallel over ``model`` (``sharding.on_mixer``:
              each rank's heads, the state and conv window where they
              lie); qwen2.5-3b at full width and depth in bf16 under
              ``DEFAULT_RULES``: the same prefill row, then
              ``Engine.generate`` of 8 tokens for 8 rows of 16 on the plain
              and on the sharded params (greedy tokens equal on one card,
              every cache leaf in its placements after each step, tok/s),
              and ``RequestScheduler`` over that engine, 16 requests (8 or
              16 prompt tokens, 4-8 new each) over 8 slots, on the plain and
              the sharded params: each request's tokens equal on one card
              (on more, equal up to a near tie of the plain logits), none
              failed, every cache leaf in its ``cache_pspecs`` placements
              with ``8 / data`` local rows at each tick, ms and tok/s;
              ``compressed_mean_grads`` (int8, topk)
              on that model's gradient tree, the error against the f32
              mean (int8 within half a quantization step of each leaf) and
              the wire bytes against an f32 all-reduce; ``ag`` / ``rs`` at
              M = 1024, K = 2048, N = 11008 in bf16 against ``torch.matmul``
              on the gathered operands (within one bf16 rounding of their
              f32 product); ``pipeline_forward`` over 36 layers of
              ``tanh(h @ W)`` at D = 2048 ``torch.equal`` to the
              sequential loop; then ``launch.dryrun``'s qwen2.5-3b
              ``train_4k``, qwen3-14b ``decode_32k`` and mamba2-1.3b
              ``decode_32k`` cells on the fake
              16 x 16 mesh (FLOPs, bytes, collectives, argument and live
              bytes a device) and their roofline rows
              (``launch.roofline``).  No kernel of the port launches.
19. examples -- the JAX package's four ``examples/*.py`` as the port's
              ``repro_torch.examples`` twins, each through its ``main`` at
              its own full settings: ``quickstart`` (ADMM block pruning,
              PBCSR, the reorder, then ``bsr_matmul`` at M = 128, f32,
              within 1e-4 x max(1, max|plain|) of ``bsr_matmul_plain``,
              timed beside its plain version and a dense ``torch.matmul``);
              ``prune_style_transfer`` (base 32, one 128 x 128 frame: ms a
              frame of the unpruned / pruned / pruned + compiler variants
              beside each one's device busy ms a frame, the last on the
              kernel backend within 1e-3 of its reference plan, exact
              conv2d / dense_matmul launches); ``serve_pruned_lm``
              (every served row and request through ``serve.parity_rule``);
              ``train_lm_100m --prune --ckpt`` (200 steps of the ~100M f32
              model: finite ce, hard-prune sparsity 0.5 +- 0.05, the last
              checkpoint restoring ``torch.equal`` params; median step ms,
              tok/s, MFU).  Their launches count in the kernels line.

The line before the last is a JSON object with every kernel's numbers (the
conv kernel once per scheme the main path launches; the pipelined kernels
launch only in the tune phase's serving); the last line is
``{"ok": true, "device": {...}}``.  Any failed check raises, and
the script exits non-zero.  Without a CUDA device, or without the
repository's ``src/repro_torch`` beside it, it exits non-zero and prints no
result.  It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import re
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, the f32 FMA rate on
#: the CUDA cores (the f32 and W8 schemes compute in true f32) and the dense
#: int8 tensor-core rate (the least time of an int8 x int8 contraction)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12

SEED = 0
BASE = 32
SIZE = 256
FRAMES = 10
BATCH = 4
TIMING_REPS = 3

#: per plan call: (plan nodes, conv2d launches, dense_matmul launches,
#: fused_elementwise launches)
EXPECTED = {
    "style_transfer": (18, 11, 5, 0),
    "coloring": (19, 12, 2, 0),
    "super_resolution": (20, 10, 8, 1),
}

#: the INT8 plans: quantized nodes by (op, scheme), then launches per plan
#: call -- the conv kernel by scheme, quant_matmul, dense_matmul,
#: fused_elementwise
EXPECTED_INT8 = {
    "style_transfer": ({("qconv2d", "w8"): 14},
                       {"f32": 2, "w8": 9, "w8a8": 0}, 5, 0, 0),
    "coloring": ({("qconv2d", "w8a8"): 11, ("qlinear", "w8a8"): 1},
                 {"f32": 2, "w8": 0, "w8a8": 10}, 2, 0, 0),
    "super_resolution": ({("qconv2d", "w8"): 16},
                         {"f32": 2, "w8": 8, "w8a8": 0}, 8, 0, 1),
}

_CONV = ("src/repro_torch/kernels/csrc/conv2d.cu", "src/repro/kernels/conv2d.py:175")
#: each entry of the kernels line: where the kernel lives and which TPU
#: kernel it replaces (the conv kernel once per scheme)
KERNELS = {
    "conv2d": _CONV,
    "conv2d_w8": _CONV,
    "conv2d_w8a8": _CONV,
    "dense_matmul": (
        "src/repro_torch/kernels/csrc/dense_matmul.cu", "src/repro/kernels/dense_matmul.py:85",
    ),
    "fused_elementwise": (
        "src/repro_torch/kernels/csrc/fused_elementwise.cu",
        "src/repro/kernels/fused_elementwise.py:39",
    ),
    "quant_matmul": (
        "src/repro_torch/kernels/csrc/quant_matmul.cu", "src/repro/kernels/quant_matmul.py:62",
    ),
    # the decoder path (qwen2.5-3b): the dense kernel once more for its bf16
    # instances; one flash kernel replaces both TPU functions (:31 without
    # lengths, :71 with them -- the main path passes lengths)
    "dense_matmul_bf16": (
        "src/repro_torch/kernels/csrc/dense_matmul.cu", "src/repro/kernels/dense_matmul.py:85",
    ),
    "flash_attention": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:71",
    ),
    "ffn_gateup": (
        "src/repro_torch/kernels/csrc/fused_ffn.cu", "src/repro/kernels/fused_ffn.py:29",
    ),
    # the block-pruned decoder (q / o projections through the compiler's
    # sparse_linear(pbcsr) nodes)
    "bsr_matmul": (
        "src/repro_torch/kernels/csrc/bsr_matmul.cu", "src/repro/kernels/bsr_matmul.py:41",
    ),
    # the tuning path: matmul / qmatmul winners with pipeline depth >= 2
    "dense_matmul_pipelined": (
        "src/repro_torch/kernels/csrc/dense_matmul_pipelined.cu",
        "src/repro/kernels/dense_matmul.py:121",
    ),
    "quant_matmul_pipelined": (
        "src/repro_torch/kernels/csrc/quant_matmul_pipelined.cu",
        "src/repro/kernels/quant_matmul.py:104",
    ),
}

#: the decoder phases: the JAX CLI's ``serve --llm`` defaults (3 prompts of
#: 4..16 tokens, 12 new tokens each, 4 sequences decoding together, a
#: 64 x 16-token KV pool) on the kernel backend
LLM_ARGS = dict(arch="qwen2.5-3b", batch=4, prompt_len=16, new_tokens=12, frames=3,
                kv_pages=64, kv_page_size=16, max_queue=1024, seed=SEED, device="cuda",
                guarded=False)
#: qwen2.5-3b's layers: each launches 5 bf16 dense_matmul (q, k, v, o, down)
#: and one ffn_gateup per plan call
LLM_LAYERS = 36
#: the decoders served after qwen2.5-3b at full width (phases 11-12)
NEW_DECODERS = ("granite-3-2b", "phi4-mini-3.8b")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


#: profiler sessions tried before a timing gives up on the profiler: now and
#: then a session returns no device events at all for kernels that ran (seen
#: once for a 6 us kernel that other sessions of the same script timed)
PROFILE_ATTEMPTS = 3


def profiled_us(torch, fn, reps: int, warmup: int = 3) -> float:
    """Device time of ``reps`` calls of ``fn``: the time of every kernel they
    launch, from torch.profiler (host work between launches is not
    counted).  A session that sees no device time is tried again, up to
    ``PROFILE_ATTEMPTS`` sessions; 0 if none saw any."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_ATTEMPTS):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        if us > 0:
            return us
    return 0.0


def device_ms(torch, fn, reps: int = 20) -> float:
    """Device time of one call of ``fn``, averaged over ``reps`` calls; where
    no profiler session saw device time, its time on the stream between CUDA
    events instead (said on a line of its own)."""
    us = profiled_us(torch, fn, reps)
    if us > 0:
        return us / reps / 1e3
    ms = call_ms(torch, fn, reps)
    print(f"  (the profiler saw no device time in {PROFILE_ATTEMPTS} sessions; "
          f"timed with CUDA events: {ms:.4f} ms)")
    return ms


def library_ms(torch, fn, reps: int = 20):
    """The library yardstick's time per call: its device time, or -- where
    the profiler attributes none of its kernels, as it did for one cuDNN
    convolution -- its time on the stream between CUDA events.  Returns the
    time and how it was taken."""
    us = profiled_us(torch, fn, reps)
    if us > 0:
        return us / reps / 1e3, "profiler"
    return call_ms(torch, fn, reps), "events"


def device_kernels(torch, fn):
    """The device kernels one call of ``fn`` launches, by name, in order
    (torch.profiler; sessions that see none are tried again)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_ATTEMPTS):
        # acc_events: keep events past the profiler's cycle end, as
        # profiled_us does (without it a session can report none)
        with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            return names
    check(False, "the profiler saw no device kernel")


def call_ms(torch, fn, reps: int = 20) -> float:
    """Time of one call of ``fn`` as the stream sees it: CUDA events around
    ``reps`` back-to-back calls (includes the host's launch overhead when
    the host is slower than the device)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float, peak_ops: float = PEAK_F32_FLOPS):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main_path_launches(ops):
    """The launch counts by entry of the kernels line (the conv kernel by
    scheme)."""
    counts = ops.kernel_launch_counts()
    by_scheme = ops.conv_scheme_launch_counts()
    by_dtype = ops.dense_dtype_launch_counts()
    return {
        "conv2d": by_scheme["f32"], "conv2d_w8": by_scheme["w8"],
        "conv2d_w8a8": by_scheme["w8a8"], "dense_matmul": by_dtype["f32"],
        "fused_elementwise": counts["fused_elementwise"], "quant_matmul": counts["quant_matmul"],
        "dense_matmul_bf16": by_dtype["bf16"], "flash_attention": counts["flash_attention"],
        "ffn_gateup": counts["ffn_gateup"], "bsr_matmul": counts["bsr_matmul"],
        "dense_matmul_pipelined": counts["dense_matmul_pipelined"],
        "quant_matmul_pipelined": counts["quant_matmul_pipelined"],
    }


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def phase_device(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"device: torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return smi


#: registers a thread of each conv kernel instance, by (scheme, BM, BN, BK),
#: from the build log's ptxas report (phase_build fills it)
CONV_REGISTERS = {}
_CONV_ENTRY = re.compile(r"conv2d_igemm(?:_int8)?_kernelILi(\d)ELi(\d+)ELi(\d+)ELi(\d+)E")
#: registers a thread of each f32 / INT8 GEMM instance, by (scheme, BM, BN,
#: BK, depth, layout): the f32 / W8 body (simt_gemm_kernel<float | signed
#: char, ...>) and the W8A8 body (int8_gemm_kernel<...>)
GEMM_REGISTERS = {}
_GEMM_ENTRY = re.compile(r"(simt_gemm_kernelI[fa]|int8_gemm_kernelI)"
                         r"Li(\d+)ELi(\d+)ELi(\d+)ELi(\d)ELi(\d)E")
_GEMM_SCHEME = {"simt_gemm_kernelIf": "f32", "simt_gemm_kernelIa": "w8",
                "int8_gemm_kernelI": "w8a8"}
#: registers a thread of each f32 gate/up body instance, by (body, template
#: arguments): ffn_gateup_simt_kernel<BM> (48, 64) and
#: ffn_gateup_skinny_kernel<VEC, MT> (4 / 1 x 1 / 2 / 4 / 8)
FFN_REGISTERS = {}
_FFN_ENTRY = re.compile(r"ffn_gateup_(simt|skinny)_kernelI((?:Li\d+E)+)E")


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.lib()
    dt = time.perf_counter() - t0
    print(f"build: {dt:.1f}s -> {path.relative_to(ROOT)}")
    log = (path.parent / "build.log").read_text()
    entry = gemm = ffn = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = _CONV_ENTRY.search(m.group(1))
            gemm = _GEMM_ENTRY.search(m.group(1))
            ffn = _FFN_ENTRY.search(m.group(1))
        spill = "spill" in line and " 0 bytes spill" not in line
        if ("registers" in line and not gemm and not ffn) or spill:
            print("  ptxas:", line.split("ptxas info    :")[-1].strip())
        regs = re.search(r"Used (\d+) registers", line)
        if regs and entry:
            CONV_REGISTERS[tuple(int(v) for v in entry.groups())] = int(regs.group(1))
        if regs and gemm:
            g = gemm.groups()
            GEMM_REGISTERS[(_GEMM_SCHEME[g[0]], *map(int, g[1:]))] = int(regs.group(1))
        if regs and ffn:
            key = (ffn.group(1), *map(int, re.findall(r"Li(\d+)E", ffn.group(2))))
            FFN_REGISTERS[key] = int(regs.group(1))
    check(len(CONV_REGISTERS) == 3 * 6, f"build log: {len(CONV_REGISTERS)} conv kernel "
                                        f"instances with registers, want 18")
    gemm_registers()
    check(len(FFN_REGISTERS) == 2 + 2 * 4, f"build log: {len(FFN_REGISTERS)} f32 gate/up "
                                          f"instances with registers, want 10")
    print("  ffn_gateup f32 registers: " + " ".join(
        f"{body}<{','.join(map(str, args))}>={r}"
        for (body, *args), r in sorted(FFN_REGISTERS.items())))
    sass_check(path)


def gemm_registers():
    """Registers a thread of every f32 / INT8 GEMM instance (3 schemes x 8
    tiles x 2 layouts), one line per scheme and layout; the f32 / W8 ring
    instances (depth 2 / 3) hold at most 8 more than the same tile at depth
    1."""
    from repro_torch.kernels import _build

    check(len(GEMM_REGISTERS) == 3 * len(_build.GEMM_TILES) * 2,
          f"build log: {len(GEMM_REGISTERS)} GEMM instances with registers, want "
          f"{3 * len(_build.GEMM_TILES) * 2}")
    for scheme in ("f32", "w8", "w8a8"):
        for layout, code in _build.LAYOUT_CODES.items():
            regs = {t: GEMM_REGISTERS[(scheme, *t, code)] for t in _build.GEMM_TILES}
            print(f"  gemm registers {scheme} {layout}: " + " ".join(
                f"{'x'.join(map(str, t))}={r}" for t, r in regs.items()))
            if scheme != "w8a8":
                for t, r in regs.items():
                    base = regs[(*t[:3], 1)]
                    check(r <= base + 8, f"{scheme} {layout} tile {t}: {r} registers, depth 1 "
                                         f"holds {base}")


#: the CUDA-core GEMM templates that must hold no bf16 instance: bf16 runs
#: the tensor-core kernel (mma_gemm_kernel) and the skinny kernel
_FMA_GEMMS = ("simt_gemm_kernel", "ffn_gateup_simt_kernel", "ffn_gateup_skinny_kernel")
#: the bf16 tensor-core kernels, whose SASS must issue HMMA
_TC_KERNELS = ("mma_gemm_kernel", "flash_attention_tc_kernel")
#: the Hopper bf16 GEMM (csrc/wgmma_gemm.cuh), whose SASS must issue HGMMA
#: (wgmma) and UTMALDG (TMA loads) and no HMMA: one instance per bf16 tile
#: of dense_matmul.cu (depth 1) and dense_matmul_pipelined.cu (depth 2 / 3),
#: one weight each, one per two-weight tile of fused_ffn.cu (its epilogue
#: GateUpEpilogue), and one per block-sparse tile of bsr_matmul.cu (its K
#: walk BsrWalk)
_WGMMA_KERNEL = "wgmma_gemm_kernel"


def sass_check(lib_path):
    """The built library's SASS (cuobjdump): every instance of the Hopper
    bf16 GEMM (``wgmma_gemm_kernel``: one weight, the two-weight gate/up
    instances, one per ``FFN_WGMMA_TILES`` tile, and the block-sparse
    instances, one per ``BSR_TMA_TILES`` pair) issues HGMMA and UTMALDG and
    no HMMA, every other bf16 tensor-core kernel (the dense
    ``mma_gemm_kernel``, flash attention's prefill body) issues HMMA, every
    W8A8 conv and GEMM instance IMMA, and no CUDA-core GEMM kernel is
    instantiated for bf16."""
    from repro_torch.kernels import _build

    tool = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True, timeout=600).stdout
    hmma, fma_bf16, imma, imma_gemm, wgmma = {}, [], {}, {}, {}
    for chunk in re.split(r"\n\s*Function : ", sass)[1:]:
        name = chunk.split("\n", 1)[0].strip()
        if _WGMMA_KERNEL in name:
            wgmma[name] = (chunk.count("HGMMA"), chunk.count("UTMALDG"),
                           len(re.findall(r"\bHMMA\b", chunk)))
        elif any(k in name for k in _TC_KERNELS):
            hmma[name] = chunk.count("HMMA")
        if "conv2d_igemm_int8_kernel" in name:
            imma[name] = chunk.count("IMMA")
        if "int8_gemm_kernel" in name:
            imma_gemm[name] = chunk.count("IMMA")
        if any(k in name for k in _FMA_GEMMS) and "bfloat16" in name:
            fma_bf16.append(name)
    check(hmma and min(hmma.values()) > 0,
          f"sass: tensor-core kernels without HMMA: {[n for n, c in hmma.items() if not c]}")
    check(not fma_bf16, f"sass: CUDA-core bf16 GEMM instances remain: {fma_bf16[:3]}")
    got = sum("flash_attention_tc_kernel" in n for n in hmma)
    check(got == 3, f"sass: {got} flash_attention_tc_kernel instances, want 3")
    check(len(imma) == 6 and min(imma.values()) > 0,
          f"sass: W8A8 conv instances without IMMA: {[n for n, c in imma.items() if not c]} "
          f"({len(imma)} instances, want 6)")
    check(len(imma_gemm) == 16 and min(imma_gemm.values()) > 0,
          f"sass: W8A8 GEMM instances without IMMA: "
          f"{[n for n, c in imma_gemm.items() if not c]} ({len(imma_gemm)} instances, want 16)")
    n_wgmma = (len(_build.BF16_GEMM_TILES) + len(_build.FFN_WGMMA_TILES)
               + len(_build.BSR_TMA_TILES))
    check(len(wgmma) == n_wgmma, f"sass: {len(wgmma)} {_WGMMA_KERNEL} instances, want {n_wgmma}")
    n_two = sum("GateUpEpilogue" in n for n in wgmma)
    check(n_two == len(_build.FFN_WGMMA_TILES),
          f"sass: {n_two} two-weight {_WGMMA_KERNEL} instances, want "
          f"{len(_build.FFN_WGMMA_TILES)}")
    n_bsr = sum("BsrWalk" in n for n in wgmma)
    check(n_bsr == len(_build.BSR_TMA_TILES),
          f"sass: {n_bsr} block-sparse {_WGMMA_KERNEL} instances, want "
          f"{len(_build.BSR_TMA_TILES)}")
    bad = [n for n, (hg, tma, hm) in wgmma.items() if not hg or not tma or hm]
    check(not bad, f"sass: {_WGMMA_KERNEL} instances without HGMMA or UTMALDG, or with HMMA: "
                   f"{bad[:3]}")
    print(f"  sass: {len(wgmma)} {_WGMMA_KERNEL} instances ({n_two} with two weights, "
          f"{n_bsr} block-sparse), "
          f"HGMMA per kernel "
          f"{min(v[0] for v in wgmma.values())}..{max(v[0] for v in wgmma.values())}, UTMALDG "
          f"{min(v[1] for v in wgmma.values())}..{max(v[1] for v in wgmma.values())}, no HMMA")
    print(f"  sass: {len(hmma)} {' / '.join(_TC_KERNELS)} instances, HMMA per kernel "
          f"{min(hmma.values())}..{max(hmma.values())}; {len(imma)} conv2d_igemm_int8_kernel "
          f"instances, IMMA per kernel {min(imma.values())}..{max(imma.values())}; "
          f"{len(imma_gemm)} int8_gemm_kernel instances, IMMA per kernel "
          f"{min(imma_gemm.values())}..{max(imma_gemm.values())}; no bf16 "
          f"instance of {', '.join(_FMA_GEMMS)}")


def phase_kernels(torch):
    """Every kernel against its plain version at the main path's shapes."""
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels import conv2d as kconv
    from repro_torch.kernels import dense_matmul as kdense
    from repro_torch.kernels import dense_matmul_pipelined as kdense_pipe
    from repro_torch.kernels import fused_elementwise as kfused
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant_matmul as kquant
    from repro_torch.kernels import quant_matmul_pipelined as kquant_pipe
    from repro_torch.kernels.ref import _ACT, xla_conv_pads
    from repro_torch.quant import QTensor, quantize_array

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    results = {name: [] for name in KERNELS}

    def record(name, label, out, want, kernel, plain, library, nb, flops, rtol=1e-4,
               peak_ops=PEAK_F32_FLOPS):
        err = (out - want).abs().max().item()
        tol = rtol * max(1.0, want.abs().max().item())
        b_ms, b_by = bound(nb, flops, peak_ops)
        ms, plain_ms = device_ms(torch, kernel), device_ms(torch, plain, reps=5)
        lib_ms, lib_how = (None, None) if library is None else library_ms(torch, library)
        lib = "n/a" if lib_ms is None else f"{lib_ms:.4f}" + (
            "(events)" if lib_how == "events" else "")
        print(f"  {name:18s} {label:42s} max_err={err:.3e} (tol {tol:.1e}) "
              f"ms={ms:.4f} call_ms={call_ms(torch, kernel):.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={lib} bound_ms={b_ms:.4f} ({b_by})")
        check(err <= tol, f"{name} {label}: max_err {err} > {tol}")
        results[name].append(dict(label=label, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by))

    def tiles_line(name, label, call, ref, want, tol, tiles):
        """Every tile of a kernel family once (``call(tile)``): torch.equal
        to the default tile's output ``ref`` and within ``tol`` of the plain
        version's ``want``; device ms of each."""
        parts = []
        for t in tiles:
            out = call(t)
            check(torch.equal(out, ref), f"{name} tile {t} {label}: differs from the default tile")
            err = (out.float() - want.float()).abs().max().item()
            check(err <= tol, f"{name} tile {t} {label}: max_err {err} > {tol}")
            parts.append(f"{'x'.join(map(str, t))}={device_ms(torch, lambda t=t: call(t), 10):.4f}")
        print(f"  {name:18s} every tile, {label}: {' '.join(parts)} ms "
              f"(each torch.equal to the default tile)")

    # -- conv2d -------------------------------------------------------------- #
    def conv_case(label, n, c_in, hw, o, k, stride, c_live=None, act=None, add_side=False,
                  scheme="f32", tiles=False):
        h, w_ = hw
        x = randn(n, c_in, h, w_)
        c = c_live or c_in
        kept = None
        if c_live:
            kept = torch.sort(torch.randperm(c_in, generator=gen, device=dev)[:c_live]).values
            kept = kept.to(torch.int32)
        wt = randn(o, c, k, k, scale=(c * k * k) ** -0.5)
        b = randn(o, scale=0.1)
        oh, ow = kconv.conv_out_hw(h, w_, k, k, stride, "SAME")
        sides = (randn(n, o, oh, ow),) if add_side else ()
        epi = (("add", 0),) if add_side else ()
        kw = dict(kept=kept, stride=stride, padding="SAME", activation=act, epilogue=epi)
        w_lib = wt
        if scheme != "f32":  # the operands as ops.conv2d hands them to the kernel
            qt = QTensor.from_float(wt, axis=0)
            wt, ws = qt.values, qt.scale
            if scheme == "w8a8":
                x_scale = torch.full((1,), x.abs().max().item() / 127.0, device=dev)
                x, ws = quantize_array(x, x_scale), ws * x_scale
            kw["ws"] = ws
            w_lib = wt.float() * ws[:, None, None, None]
        out = kconv.conv2d_gemm(x, wt, b, *sides, **kw)
        want = kconv.conv2d_plain(x, wt, b, *sides, **kw)
        # library yardstick: cuDNN (TF32 off) on the gathered, XLA-padded
        # input and, for the INT8 schemes, the dequantized filter (the
        # gather, the pad and the dequantization are prepared outside the
        # timing)
        xg = x if kept is None else x.index_select(1, kept)
        ph = xla_conv_pads(h, k, stride, "SAME", 0)
        pw = xla_conv_pads(w_, k, stride, "SAME", 1)
        xp = F.pad(xg.float(), (pw[0], pw[1], ph[0], ph[1]))

        def library():
            y = _ACT[act](F.conv2d(xp, w_lib, b, stride=stride))
            return y + sides[0] if add_side else y

        nb = nbytes(xg, wt, kw.get("ws"), b, kept, *sides, out)
        flops = 2.0 * n * oh * ow * o * c * k * k
        name = "conv2d" if scheme == "f32" else f"conv2d_{scheme}"
        rtol = 1e-5 if scheme == "w8a8" else 1e-4
        record(name, label, out, want, lambda: kconv.conv2d_gemm(x, wt, b, *sides, **kw),
               lambda: kconv.conv2d_plain(x, wt, b, *sides, **kw), library, nb, flops,
               rtol=rtol, peak_ops=PEAK_INT8_OPS if scheme == "w8a8" else PEAK_F32_FLOPS)
        tile = _build.conv_default_tile(scheme, o)
        regs = CONV_REGISTERS[(_build.SCHEME_CODES[scheme], *tile)]
        extra = ""
        if scheme == "w8a8":  # the int8 tensor-core body's own tile; exact int32 sums
            sh = _build.conv_w8a8_shape(tile)
            extra = (f" (W8A8 body {sh['bm']}x{sh['bn']}x{sh['bk']}, {sh['threads']} threads; "
                     f"torch.equal to the plain version: {torch.equal(out, want)})")
        print(f"  {name:18s} {label:42s} tile {'x'.join(map(str, tile))}, {regs} registers a "
              f"thread{extra}")
        if tiles:
            tiles_line(name, label, lambda t: kconv.conv2d_gemm(
                x, wt, b, *sides, **kw, block_m=t[0], block_n=t[1], block_k=t[2]),
                out, want, rtol * max(1.0, want.abs().max().item()), _build.CONV_TILES)

    conv_case("7x7 s1 3->32 @256^2 n4", BATCH, 3, (SIZE, SIZE), BASE, 7, 1, tiles=True)
    conv_case("3x3 s2 16-of-32->64 @256^2 n4", BATCH, 32, (SIZE, SIZE), 64, 3, 2, c_live=16)
    conv_case("3x3 s1 96-of-192->32 +add @256^2 n4", BATCH, 192, (SIZE, SIZE), 32, 3, 1,
              c_live=96, add_side=True)
    conv_case("3x3 s1 8-of-16->2 tanh @256^2 n4", BATCH, 16, (SIZE, SIZE), 2, 3, 1,
              c_live=8, act="tanh")
    conv_case("3x3 s2 24->40 relu @37x29 n2", 2, 24, (37, 29), 40, 3, 2, act="relu")
    # INT8 schemes: the first case of each is its headline (main-path shape)
    conv_case("w8 3x3 s1 96-of-192->32 +add @256^2 n4", BATCH, 192, (SIZE, SIZE), 32, 3, 1,
              c_live=96, add_side=True, scheme="w8", tiles=True)
    conv_case("w8 3x3 s2 16-of-32->64 @256^2 n4", BATCH, 32, (SIZE, SIZE), 64, 3, 2,
              c_live=16, scheme="w8")
    conv_case("w8 3x3 s2 24->40 relu @37x29 n2", 2, 24, (37, 29), 40, 3, 2, act="relu",
              scheme="w8")
    conv_case("w8a8 3x3 s1 64-of-128->128 relu @64^2 n4", BATCH, 128, (64, 64), 128, 3, 1,
              c_live=64, act="relu", scheme="w8a8", tiles=True)
    conv_case("w8a8 3x3 s2 32-of-64->64 relu @128^2 n4", BATCH, 64, (128, 128), 64, 3, 2,
              c_live=32, act="relu", scheme="w8a8")
    conv_case("w8a8 3x3 s2 24->40 +add @37x29 n2", 2, 24, (37, 29), 40, 3, 2, add_side=True,
              scheme="w8a8")
    # ragged: 13 kept channels (K = 117: no 16-byte filter rows), O = 40
    # against every derived tile width
    conv_case("w8a8 3x3 s1 13-of-16->40 +add @37x29 n2", 2, 16, (37, 29), 40, 3, 1,
              c_live=13, add_side=True, scheme="w8a8", tiles=True)

    def gemm_call(tiled, pipelined):
        """``call(tile)`` for tiles_line: the tiled kernel at depth 1, the
        pipelined one above it."""
        def call(t, *args, **kw):
            if t[3] == 1:
                return tiled(*args, **kw, block_m=t[0], block_n=t[1], block_k=t[2])
            return pipelined(*args, **kw, block_m=t[0], block_n=t[1], block_k=t[2], depth=t[3])
        return call

    def pipelined_cases(name, label, fn, plain, out, want, library, nb, flops, **rec):
        """The pipelined kernel at depth 2 and 3 on the case's inputs (its
        default tile): torch.equal to the tiled kernel's ``out``, and within
        tolerance of the plain version as ``record`` checks."""
        for depth in (2, 3):
            got = fn(depth)
            check(torch.equal(got, out), f"{name} depth {depth} {label}: differs from the "
                                         f"tiled kernel")
            record(name, f"d{depth} {label}", got, want, lambda d=depth: fn(d), plain, library,
                   nb, flops, **rec)

    # -- dense_matmul -------------------------------------------------------- #
    def dense_case(label, m, k, n, act=None, sides_epi=False, pipelined=False, tiles=False):
        x = randn(m, k)
        wt = randn(k, n, scale=k ** -0.5)
        b = randn(n, scale=0.1)
        sides = (randn(m, n), randn(m, n)) if sides_epi else ()
        epi = (("add", 0), ("mul", 1)) if sides_epi else ()
        kw = dict(activation=act, epilogue=epi)
        out = kdense.dense_matmul(x, wt, b, *sides, **kw)
        want = kdense.dense_matmul_plain(x, wt, b, *sides, **kw)

        def library():
            y = _ACT[act](torch.addmm(b, x, wt))
            return (y + sides[0]) * sides[1] if sides_epi else y

        nb, flops = nbytes(x, wt, b, *sides, out), 2.0 * m * n * k
        record("dense_matmul", label, out, want,
               lambda: kdense.dense_matmul(x, wt, b, *sides, **kw),
               lambda: kdense.dense_matmul_plain(x, wt, b, *sides, **kw), library, nb, flops)
        if pipelined:
            pipelined_cases("dense_matmul_pipelined", label, lambda d: kdense_pipe.
                            dense_matmul_pipelined(x, wt, b, *sides, **kw, depth=d),
                            lambda: kdense.dense_matmul_plain(x, wt, b, *sides, **kw),
                            out, want, library, nb, flops)
        if tiles:
            call = gemm_call(kdense.dense_matmul, kdense_pipe.dense_matmul_pipelined)
            tiles_line("dense_matmul", label, lambda t: call(t, x, wt, b, *sides, **kw), out,
                       want, 1e-4 * max(1.0, want.abs().max().item()), _build.GEMM_TILES)

    dense_case("M=4*256^2 K=32 N=192 relu", BATCH * SIZE * SIZE, BASE, 6 * BASE, act="relu",
               pipelined=True, tiles=True)
    dense_case("M=4 K=64 N=64", BATCH, 2 * BASE, 2 * BASE)
    dense_case("M=1000 K=50 N=70 add+mul", 1000, 50, 70, sides_epi=True, pipelined=True)

    # -- quant_matmul -------------------------------------------------------- #
    def quant_case(label, m, k, n, scheme, act=None, sides_epi=False, tiles=False):
        x = randn(m, k)
        qt = QTensor.from_float(randn(k, n, scale=k ** -0.5), axis=1)
        wq, ws = qt.values, qt.scale
        b = randn(n, scale=0.1)
        if scheme == "w8a8":  # the operands as ops.qmatmul hands them to the kernel
            x_scale = torch.full((1,), x.abs().max().item() / 127.0, device=dev)
            x, ws = quantize_array(x, x_scale), ws * x_scale
        sides = (randn(m, n), randn(m, n)) if sides_epi else ()
        epi = (("add", 0), ("mul", 1)) if sides_epi else ()
        kw = dict(activation=act, epilogue=epi)
        out = kquant.quant_matmul(x, wq, ws, b, *sides, **kw)
        want = kquant.quant_matmul_plain(x, wq, ws, b, *sides, **kw)

        def tail(y):
            y = _ACT[act](y)
            return (y + sides[0]) * sides[1] if sides_epi else y

        # library yardstick: an int32 GEMM where torch._int_mm's shape rules
        # allow it (M > 16, K and N multiples of 8), then the rescale; for
        # W8, addmm on the dequantized f32 weight (prepared outside timing)
        library = None
        if scheme == "w8a8" and m > 16 and k % 8 == 0 and n % 8 == 0:
            def library():
                return tail(torch._int_mm(x, wq).float() * ws + b)
        elif scheme == "w8":
            w_deq = wq.float() * ws

            def library():
                return tail(torch.addmm(b, x, w_deq))

        nb, flops = nbytes(x, wq, ws, b, *sides, out), 2.0 * m * n * k
        rec = dict(rtol=1e-5 if scheme == "w8a8" else 1e-4,
                   peak_ops=PEAK_INT8_OPS if scheme == "w8a8" else PEAK_F32_FLOPS)
        record("quant_matmul", label, out, want,
               lambda: kquant.quant_matmul(x, wq, ws, b, *sides, **kw),
               lambda: kquant.quant_matmul_plain(x, wq, ws, b, *sides, **kw), library, nb, flops,
               **rec)
        pipelined_cases("quant_matmul_pipelined", label, lambda d: kquant_pipe.
                        quant_matmul_pipelined(x, wq, ws, b, *sides, **kw, depth=d),
                        lambda: kquant.quant_matmul_plain(x, wq, ws, b, *sides, **kw),
                        out, want, library, nb, flops, **rec)
        if tiles:
            call = gemm_call(kquant.quant_matmul, kquant_pipe.quant_matmul_pipelined)
            tiles_line("quant_matmul", label, lambda t: call(t, x, wq, ws, b, *sides, **kw), out,
                       want, rec["rtol"] * max(1.0, want.abs().max().item()), _build.GEMM_TILES)

    quant_case("w8 M=4*256^2 K=32 N=192 relu", BATCH * SIZE * SIZE, BASE, 6 * BASE, "w8",
               act="relu", tiles=True)
    quant_case("w8a8 M=4*64^2 K=128 N=64 relu", BATCH * 64 * 64, 4 * BASE, 2 * BASE, "w8a8",
               act="relu", tiles=True)
    quant_case("w8a8 M=4 K=64 N=64 relu", BATCH, 2 * BASE, 2 * BASE, "w8a8", act="relu")
    quant_case("w8 M=37 K=70 N=50 add+mul", 37, 70, 50, "w8", sides_epi=True)
    quant_case("w8a8 M=37 K=70 N=50 add+mul", 37, 70, 50, "w8a8", sides_epi=True)

    # -- the 1x1-conv path: NCHW in and out, through ops.conv2d --------------- #
    def rows(t):  # NCHW -> pixel-major rows, as the path permuted before
        return t.permute(0, 2, 3, 1).reshape(-1, t.shape[1]).contiguous()

    def conv1x1_case(label, n, c, hw, o, scheme, act="relu"):
        """``ops.conv2d`` on a stride-1 1x1 conv: the GEMM kernel in its NCHW
        layout, ``torch.equal`` to the row-major kernel on the permuted
        operands (permuted back) and within tolerance of the NCHW plain
        version; one device kernel a call for f32 / W8 (no layout copy);
        every tile and depth ``torch.equal`` to the default; ``F.conv2d``
        (TF32 off; the dequantized filter for INT8) as the library call."""
        x = randn(n, c, *hw)
        wt = randn(o, c, 1, 1, scale=c ** -0.5)
        b = randn(o, scale=0.1)
        kw = dict(activation=act)
        w_lib, xk, pre = wt, x, ()
        if scheme != "f32":
            qt = QTensor.from_float(wt, axis=0)
            wt, kw["w_scale"] = qt.values, qt.scale
            w_lib = wt.float() * qt.scale[:, None, None, None]
            ws = qt.scale.float()
            if scheme == "w8a8":  # the operands as ops.qmatmul hands them to the kernel
                kw["x_scale"] = x.abs().max().item() / 127.0
                s = ops.scale_tensor(kw["x_scale"], x)
                xk, ws = quantize_array(x, s), ws * s
            pre = (ws,)
        w2 = wt.reshape(o, c)
        name = "dense_matmul" if scheme == "f32" else "quant_matmul"
        tiled, piped, plain_fn = ((kdense.dense_matmul, kdense_pipe.dense_matmul_pipelined,
                                   kdense.dense_matmul_plain) if scheme == "f32" else
                                  (kquant.quant_matmul, kquant_pipe.quant_matmul_pipelined,
                                   kquant.quant_matmul_plain))

        def call():
            return ops.conv2d(x, wt, b, **kw)

        out = call()
        row = tiled(rows(xk), w2.t().contiguous(), *pre, b, activation=act)
        check(torch.equal(out, row.reshape(n, *hw, o).permute(0, 3, 1, 2)),
              f"{name} {label}: NCHW differs from the row-major kernel permuted")
        plain = lambda: plain_fn(xk, w2, *pre, b, activation=act, _layout="nchw")  # noqa: E731
        kernels = device_kernels(torch, call)
        gemm = [k for k in kernels if "gemm_kernel" in k]
        check(len(gemm) == 1 and (scheme == "w8a8" or len(kernels) == 1),
              f"{name} {label}: kernels of one ops.conv2d call: {kernels}")
        nb = nbytes(xk, wt, *pre, b, out)
        flops = 2.0 * n * hw[0] * hw[1] * o * c
        rtol = 1e-5 if scheme == "w8a8" else 1e-4
        kernel = lambda: tiled(xk, w2, *pre, b, activation=act, _layout="nchw")  # noqa: E731
        record(name, f"nchw {scheme} {label}", out, plain(), kernel, plain,
               lambda: _ACT[act](F.conv2d(x, w_lib, b)), nb, flops, rtol=rtol,
               peak_ops=PEAK_INT8_OPS if scheme == "w8a8" else PEAK_F32_FLOPS)
        print(f"  {name:18s} nchw {scheme} {label}: one ops.conv2d call launches "
              f"{', '.join(k.split('(')[0][:60] for k in kernels)}")
        call_t = gemm_call(tiled, piped)
        tiles_line(name, f"nchw {scheme} {label}",
                   lambda t: call_t(t, xk, w2, *pre, b, activation=act, _layout="nchw"), out,
                   out, rtol * max(1.0, out.abs().max().item()), _build.GEMM_TILES)

    # super resolution's res{i}_expand (f32, W8) and coloring's 1x1 (W8A8)
    conv1x1_case("1x1 32->192 relu @256^2 n4", BATCH, BASE, (SIZE, SIZE), 6 * BASE, "f32")
    conv1x1_case("1x1 32->192 relu @256^2 n4", BATCH, BASE, (SIZE, SIZE), 6 * BASE, "w8")
    conv1x1_case("1x1 128->64 relu @64^2 n4", BATCH, 4 * BASE, (64, 64), 2 * BASE, "w8a8")

    # -- fused_elementwise --------------------------------------------------- #
    def fused_case(label, m, d, steps, n_sides, n_norms):
        x = randn(m, d)
        sides = [randn(m, d) for _ in range(n_sides)]
        norms = [(randn(d, scale=0.1) + 1.0, randn(d, scale=0.1)) for _ in range(n_norms)]
        out = kfused.fused_elementwise(x, sides, steps, norms)
        want = kfused.fused_elementwise_plain(x, sides, steps, norms)
        flops = float(m * d * sum(8 if s[0] == "norm" else 1 for s in steps))
        nb = nbytes(x, *sides, *[t for pair in norms for t in pair], out)
        record("fused_elementwise", label, out, want,
               lambda: kfused.fused_elementwise(x, sides, steps, norms),
               lambda: kfused.fused_elementwise_plain(x, sides, steps, norms), None, nb, flops)

    fused_case("[4,32,256,256] add,add", BATCH * BASE * SIZE, SIZE,
               (("add", 0), ("add", 1)), 2, 0)
    fused_case("[333,200] add,norm,gelu,mul", 333, 200,
               (("add", 0), ("norm", 0, 1e-5), ("activation", "gelu"), ("mul", 1)), 2, 1)
    torch.cuda.synchronize()
    return results


def attention_work(q_shape, kv_shape, lengths, causal):
    """Keys each query row reads under the kernel's rule (a row reads its
    valid prefix: ``col < length`` and, causal, ``col <= row``; a row with
    no valid key reads every key, masked), as ``(key rows per (b, kv
    group), query-key pairs)``."""
    b, h, sq, _ = q_shape
    g, skv = kv_shape[1], kv_shape[2]
    kv_rows = pairs = 0
    for bi in range(b):
        n = skv if lengths is None else int(lengths[bi])
        if n <= 0:
            row_keys = [skv] * sq
        else:
            n = min(n, skv)
            row_keys = [min(n, r + 1) if causal else n for r in range(sq)]
        kv_rows += g * max(row_keys)
        pairs += h * sum(row_keys)
    return kv_rows, pairs


def phase_llm_kernels(torch, results):
    """The decoder's kernels at qwen2.5-3b's shapes (d_model 2048, 16 heads,
    2 KV heads, head_dim 128, d_ff 11008) against their plain versions:
    flash attention (prefill, decode, no lengths), the fused gate/up FFN and
    the bf16 dense matmul of the q / k / v / o / down projections."""
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels import dense_matmul as kdense
    from repro_torch.kernels import dense_matmul_pipelined as kdense_pipe
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import fused_ffn as kffn
    from repro_torch.kernels.ref import _ACT, bf16_ulp

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    bf16 = torch.bfloat16

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def record(name, label, out, want, kernel, plain, library, nb, flops, peak_ops):
        out, want = out.float(), want.float()
        err = (out - want).abs().max().item()
        top = want.abs().max().item()
        # f32 outputs: the f32 sums differ in order only; bf16 outputs: the
        # same f32 sums rounded once, so one bf16 ulp of the largest value
        bf = kernel().dtype == torch.bfloat16
        tol = bf16_ulp(top) if bf else 1e-4 * max(1.0, top)
        b_ms, b_by = bound(nb, flops, peak_ops)
        ms, plain_ms = device_ms(torch, kernel), device_ms(torch, plain, reps=5)
        lib_ms, lib_how = (None, None) if library is None else library_ms(torch, library)
        lib = "n/a" if lib_ms is None else f"{lib_ms:.4f}" + (
            "(events)" if lib_how == "events" else "")
        print(f"  {name:18s} {label:42s} max_err={err:.3e} (tol {tol:.1e}) "
              f"ms={ms:.4f} call_ms={call_ms(torch, kernel):.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={lib} bound_ms={b_ms:.4f} ({b_by})")
        check(err <= tol, f"{name} {label}: max_err {err} > {tol}")
        results.setdefault(name, []).append(dict(
            label=label, max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=b_ms, bound_by=b_by))

    # -- flash_attention ----------------------------------------------------- #
    def flash_case(label, b, h, g, sq, skv, d, lengths, causal, q_dtype, kv_dtype):
        # the executor's layouts: q [B, S, H*d] and k/v [B, S, G*d] viewed as
        # [B, heads, S, d] (strided, no copy)
        q = randn(b, sq, h, d, dtype=q_dtype).permute(0, 2, 1, 3)
        k = randn(b, skv, g, d, dtype=kv_dtype).permute(0, 2, 1, 3)
        v = randn(b, skv, g, d, dtype=kv_dtype).permute(0, 2, 1, 3)
        lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32, device=dev)
        kw = dict(causal=causal)
        out = kflash.flash_attention(q, k, v, lens, **kw)
        want = kflash.flash_attention_plain(q, k, v, lens, **kw)
        # library yardstick: SDPA on the same function -- KV groups repeated
        # and a boolean mask built outside the timing, q in k's type
        rep = h // g
        kr, vr = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
        ql = q.to(kv_dtype)
        cols = torch.arange(skv, device=dev)
        mask = torch.ones(b, 1, sq, skv, dtype=torch.bool, device=dev)
        if causal:
            mask &= cols[None, None, None, :] <= torch.arange(sq, device=dev)[None, None, :, None]
        if lens is not None:
            mask &= cols[None, None, None, :] < lens[:, None, None, None]

        def library():
            return F.scaled_dot_product_attention(ql, kr, vr, attn_mask=mask)

        kv_rows, pairs = attention_work(q.shape, k.shape, lengths, causal)
        esz_q, esz_kv = q.element_size(), k.element_size()
        nb = 2 * q.numel() * esz_q + 2 * kv_rows * d * esz_kv + (0 if lens is None else 4 * b)
        both_bf16 = q_dtype == bf16 and kv_dtype == bf16
        fp = kflash.plan_for(q, k, v, causal)
        print(f"  {'flash_attention':18s} {label:42s} route {fp.route}"
              + (f" ({fp.nsplit} splits of {fp.chunk} keys)" if fp.route == "split" else ""))
        record("flash_attention", label, out, want,
               lambda: kflash.flash_attention(q, k, v, lens, **kw),
               lambda: kflash.flash_attention_plain(q, k, v, lens, **kw), library, nb,
               4.0 * pairs * d, PEAK_BF16_FLOPS if both_bf16 else PEAK_F32_FLOPS)

    f32 = torch.float32
    routes0 = dict(kflash.route_launches)
    flash_case("decode q bf16 kv f32 B3 H16/G2 span1024 +len", 3, 16, 2, 1, 1024, 128,
               [1000, 517, 64], False, bf16, f32)
    flash_case("prefill bf16 B3 H16/G2 S16 causal +len", 3, 16, 2, 16, 16, 128,
               [16, 11, 5], True, bf16, bf16)
    flash_case("bf16 B3 H16/G2 S100 causal, no lengths", 3, 16, 2, 100, 100, 128,
               None, True, bf16, bf16)
    flash_case("f32 B2 H4/G2 Sq3 Skv37 d32 +len (0 incl.)", 2, 4, 2, 3, 37, 32,
               [0, 29], False, f32, f32)
    flash_case("prefill bf16 B3 H16/G2 S512 causal +len", 3, 16, 2, 512, 512, 128,
               [512, 300, 77], True, bf16, bf16)
    flash_case("decode q bf16 kv f32 B3 H16/G2 span4096 +len", 3, 16, 2, 1, 4096, 128,
               [4000, 2100, 64], False, bf16, f32)
    flash_case("decode q bf16 kv f32 B1 H16/G2 span1024 +len", 1, 16, 2, 1, 1024, 128,
               [1000], False, bf16, f32)
    # splits wholly past row 1's length, and a length-0 row (a uniform average)
    flash_case("decode bf16 B2 H16/G2 span512 +len [0, 40]", 2, 16, 2, 1, 512, 128,
               [0, 40], False, bf16, bf16)
    # the tensor-core route at d = 64 with G = H and a length-0 row; the
    # SIMT route (f32 prefill, the smoke decoder's)
    flash_case("bf16 B2 H8/G8 S40 d64 causal +len [40, 0]", 2, 8, 8, 40, 40, 64, [40, 0],
               True, bf16, bf16)
    flash_case("f32 B2 H4/G2 S20 d32 causal +len [20, 0]", 2, 4, 2, 20, 20, 32, [20, 0],
               True, f32, f32)
    unused = [r for r, n in kflash.route_launches.items() if n == routes0[r]]
    check(not unused, f"flash_attention: routes {unused} not launched by the kernel cases")

    #: device ms of the decoder's GEMM launches by phase and role, for the
    #: per-plan-call sums below (qwen2.5-3b; per_arch: every decoder)
    per_call = {"prefill": {}, "decode": {}}
    per_arch = {}

    def took(mod, before, want_body, what):
        """The one body a launch of ``mod`` took since ``before``
        (``route_launches``) is ``want_body``."""
        ran = {r for r, c in mod.route_launches.items() if c != before[r]}
        check(ran == {want_body}, f"{what}: ran {sorted(ran)}, want {want_body}")

    # -- ffn_gateup ---------------------------------------------------------- #
    def ffn_case(label, m, k, f, dtype, act="silu", role=None, every_tile=False):
        x = randn(m, k, dtype=dtype)
        wg = randn(k, f, scale=k ** -0.5, dtype=dtype)
        wu = randn(k, f, scale=k ** -0.5, dtype=dtype)
        before = dict(kffn.route_launches)
        out = kffn.ffn_gateup(x, wg, wu, activation=act)
        want = kffn.ffn_gateup_plain(x, wg, wu, activation=act)
        actf = _ACT[act]
        if dtype == torch.float32:
            took(kffn, before, "stream" if m <= _build.SKINNY_MT and k > 0 else "simt",
                 f"ffn_gateup f32 {label}")
            ffn_f32_checks(label, x, wg, wu, act, out)
        else:
            ffn_bf16_checks(label, x, wg, wu, act, out, before, want, every_tile)

        def library():
            return actf(torch.matmul(x, wg)) * torch.matmul(x, wu)

        peak = PEAK_BF16_FLOPS if dtype == bf16 else PEAK_F32_FLOPS
        record("ffn_gateup", label, out, want,
               lambda: kffn.ffn_gateup(x, wg, wu, activation=act),
               lambda: kffn.ffn_gateup_plain(x, wg, wu, activation=act), library,
               nbytes(x, wg, wu, out), 4.0 * m * k * f, peak)
        if role:
            per_call[role[0]][role[1]] = results["ffn_gateup"][-1]["ms"]

    def ffn_f32_checks(label, x, wg, wu, act, out):
        """An f32 call launches one kernel (no fill or memset) and, after
        the first call, allocates no counter buffer; its route and plan;
        weights 4 bytes past a 16-byte boundary (4-byte loads / copies) give
        the same bits, the K ranges being fixed by the shape."""
        m, k = x.shape
        f = wg.shape[1]
        call = lambda: kffn.ffn_gateup(x, wg, wu, activation=act)  # noqa: E731
        allocs = _build.counter_allocations
        names = device_kernels(torch, call)
        check(len(names) == 1 and "ffn_gateup_s" in names[0],
              f"ffn_gateup {label}: one call launched {names}")
        check(_build.counter_allocations == allocs,
              f"ffn_gateup {label}: {_build.counter_allocations - allocs} counter buffers "
              f"allocated after the first call")
        if m <= _build.SKINNY_MT and k > 0:
            route = f"stream, plan {_build.skinny_plan_f32(m, f, k, 4 if f % 4 == 0 else 1)}"
        else:
            route = (f"two-weight GEMM, tile {_build.ffn_tile_f32(m)}, K ranges "
                     f"{_build.ffn_split_f32(m, f, k)}")
        shifted = [torch.empty(k * f + 1, device=dev)[1:].view(k, f) for _ in range(2)]
        for s_, w_ in zip(shifted, (wg, wu)):
            s_.copy_(w_)
        same = torch.equal(kffn.ffn_gateup(x, *shifted, activation=act), out)
        check(same, f"ffn_gateup {label}: 4-byte-aligned weights give other bits")
        print(f"  {'ffn_gateup':18s} {label:42s} {route}; 1 kernel a call "
              f"({names[0].split('(')[0][:48]}), no counter allocation; unaligned weights "
              f"torch.equal")

    def ffn_bf16_checks(label, x, wg, wu, act, out, before, want, every_tile):
        """A bf16 call ran the body ``_build.ffn_body`` names
        (``route_launches``): the two-weight wgmma body at every served
        shape, ``mma_gemm`` where TMA cannot address the operands.  A wgmma
        call launches one kernel and allocates its output and nothing else
        (no workspace, no counters); ``every_tile``: each tile of
        ``FFN_WGMMA_TILES`` under the plan's K ranges gives the plan's
        bits."""
        m, k = x.shape
        f = wg.shape[1]
        body = _build.ffn_body(f, k)
        took(kffn, before, body, f"ffn_gateup bf16 {label}")
        if k % 8 == 0 and f % 8 == 0:
            check(body == "wgmma", f"ffn_gateup bf16 {label}: the rule picks {body}")
        if body != "wgmma":
            print(f"  {'ffn_gateup':18s} {label:42s} route {body}")
            return
        call = lambda: kffn.ffn_gateup(x, wg, wu, activation=act)  # noqa: E731
        tile, kchunk, nsplit = _build.ffn_tma_plan(m, f, k)
        names = device_kernels(torch, call)
        check(len(names) == 1 and "wgmma_gemm_kernel" in names[0],
              f"ffn_gateup {label}: one call launched {names}")
        counters = _build.counter_allocations
        blocks = torch.cuda.memory_stats()["allocation.all.allocated"]
        call()
        blocks = torch.cuda.memory_stats()["allocation.all.allocated"] - blocks
        check(blocks == 1 and _build.counter_allocations == counters,
              f"ffn_gateup {label}: a call allocated {blocks} blocks and "
              f"{_build.counter_allocations - counters} counter buffers, want its output alone")
        parts = []
        real = _build.ffn_tma_plan
        try:
            for t in _build.FFN_WGMMA_TILES if every_tile else ():
                _build.ffn_tma_plan = lambda *_, t=t: (t, kchunk, nsplit)
                got = call()
                check(torch.equal(got, out), f"ffn_gateup tile {t} {label}: differs from the "
                                             f"plan's tile {tile}")
                parts.append(f"{'x'.join(map(str, t))}={device_ms(torch, call, 10):.4f}")
        finally:
            _build.ffn_tma_plan = real
        print(f"  {'ffn_gateup':18s} {label:42s} route wgmma, tile {'x'.join(map(str, tile))}, "
              f"{nsplit} K ranges of {kchunk}; 1 kernel a call, its output the one allocation"
              + (f"; every tile torch.equal: {' '.join(parts)} ms" if parts else ""))

    ffn_case("decode M=3 K=2048 F=11008 bf16 silu", 3, 2048, 11008, bf16,
             role=("decode", "ffn"), every_tile=True)
    ffn_case("prefill M=48 K=2048 F=11008 bf16 silu", 48, 2048, 11008, bf16,
             role=("prefill", "ffn"), every_tile=True)
    ffn_case("M=5 K=70 F=50 f32 gelu (ragged)", 5, 70, 50, torch.float32, "gelu")
    # the f32 instance the smoke decoder launches (d_model 128, d_ff 256; one
    # launch a layer, 2 layers): decode rows = prompts, prefill rows =
    # prompts x the longest prompt
    import argparse

    from repro_torch.configs import smoke_config
    from repro_torch.launch import serve

    smoke = smoke_config("qwen2.5-3b")
    prompts = serve.llm_prompts(argparse.Namespace(**LLM_ARGS), smoke)
    m_pre = len(prompts) * max(len(p) for p in prompts)
    smoke_ms = {}
    for label, m in (("decode", len(prompts)), ("prefill", m_pre)):
        ffn_case(f"smoke {label} M={m} K={smoke.d_model} F={smoke.d_ff} f32 silu "
                 f"({smoke.n_layers} launches a plan call)", m, smoke.d_model, smoke.d_ff,
                 torch.float32)
        smoke_ms[label] = results["ffn_gateup"][-1]["ms"]
    print(f"  {'ffn_gateup':18s} smoke decoder per plan call ({smoke.n_layers} layers, device "
          f"ms x launches): prefill {smoke.n_layers * smoke_ms['prefill']:.4f} ms, decode "
          f"{smoke.n_layers * smoke_ms['decode']:.4f} ms")
    ffn_case("M=20 K=130 F=77 bf16 silu (ragged)", 20, 130, 77, bf16)
    # the f32 routes at qwen2.5-3b's widths (kernel alone: every full-width
    # decoder serves bf16), and the two-weight GEMM on a ragged shape
    ffn_case("decode M=3 K=2048 F=11008 f32 silu", 3, 2048, 11008, torch.float32)
    ffn_case("prefill M=48 K=2048 F=11008 f32 silu", 48, 2048, 11008, torch.float32)
    ffn_case("M=20 K=130 F=77 f32 gelu (ragged)", 20, 130, 77, torch.float32, "gelu")

    # -- dense_matmul, bf16 -------------------------------------------------- #
    def dense_bf16_case(label, m, k, n, bias=True, add=False, pipelined=False, role=None):
        x = randn(m, k, dtype=bf16)
        wt = randn(k, n, scale=k ** -0.5, dtype=bf16)
        b = randn(n, scale=0.1, dtype=bf16) if bias else None
        sides = (randn(m, n, dtype=bf16),) if add else ()
        kw = dict(epilogue=(("add", 0),) if add else ())
        # the body the shape's rule picks: the TMA + wgmma body at every
        # served prefill shape and at decode for N <= TMA_DECODE_MAX_N (k /
        # v, on _build.TMA_DECODE_TILE), the skinny kernel for the other
        # decode shapes, mma_gemm.cuh for odd K or N at prefill
        body = _build.bf16_body(m, n, k)
        tma = k % 8 == 0 and n % 8 == 0
        if m <= _build.SKINNY_MT:
            want = "wgmma" if tma and n <= _build.TMA_DECODE_MAX_N else "skinny"
        else:
            want = "wgmma" if tma else "mma_gemm"
        check(body == want, f"dense_matmul bf16 {label}: the rule picks {body}, want {want}")
        before = dict(kdense.route_launches)
        out = kdense.dense_matmul(x, wt, b, *sides, **kw)
        took(kdense, before, body, f"dense_matmul bf16 {label}")
        want = kdense.dense_matmul_plain(x, wt, b, *sides, **kw)

        def library():
            y = torch.addmm(b, x, wt) if bias else torch.matmul(x, wt)
            return y + sides[0] if add else y

        nb, flops = nbytes(x, wt, b, *sides, out), 2.0 * m * n * k
        plain = lambda: kdense.dense_matmul_plain(x, wt, b, *sides, **kw)  # noqa: E731
        record("dense_matmul_bf16", label, out, want,
               lambda: kdense.dense_matmul(x, wt, b, *sides, **kw), plain, library, nb, flops,
               PEAK_BF16_FLOPS)
        if role:
            per_call[role[0]][role[1]] = results["dense_matmul_bf16"][-1]["ms"]
        if not pipelined:
            return
        # the ring kernel at depth 2 and 3 (bit-equal to the tiled kernel),
        # then every bf16 GEMM tile once (bit-equal to the default tile)
        for depth in (2, 3):
            fn = lambda d=depth: kdense_pipe.dense_matmul_pipelined(  # noqa: E731
                x, wt, b, *sides, **kw, depth=d)
            before = dict(kdense_pipe.route_launches)
            got = fn()
            took(kdense_pipe, before, _build.bf16_body(m, n, k, named=True),
                 f"dense_matmul_pipelined bf16 d{depth} {label}")
            check(torch.equal(got, out), f"dense_matmul_pipelined bf16 d{depth} {label}: "
                                         f"differs from the tiled kernel")
            record("dense_matmul_pipelined", f"d{depth} bf16 {label}", got, want, fn, plain,
                   library, nb, flops, PEAK_BF16_FLOPS)
        parts = []
        for t in _build.BF16_GEMM_TILES:
            def call(t=t):
                if t[3] == 1:
                    return kdense.dense_matmul(x, wt, b, *sides, **kw, block_m=t[0],
                                               block_n=t[1], block_k=t[2])
                return kdense_pipe.dense_matmul_pipelined(
                    x, wt, b, *sides, **kw, block_m=t[0], block_n=t[1], block_k=t[2], depth=t[3])
            check(torch.equal(call(), out), f"dense_matmul bf16 tile {t} {label}: differs from "
                                            f"the default tile")
            parts.append(f"{'x'.join(map(str, t))}={device_ms(torch, call, 10):.4f}")
        print(f"  {'dense_matmul_bf16':18s} every tile, {label}: {' '.join(parts)} ms "
              f"(each torch.equal to the default tile)")

    # every projection the decoder plans launch, at decode (M = 3 rows: k /
    # v on the TMA + wgmma body, every tile and depth too on the decode
    # plan's K ranges; q / o / down on the skinny kernel) and at prefill
    # (M = 48, the TMA + wgmma body)
    dense_bf16_case("q decode M=3 2048->2048 +bias", 3, 2048, 2048, role=("decode", "q"))
    dense_bf16_case("k/v decode M=3 2048->256 +bias", 3, 2048, 256, pipelined=True,
                    role=("decode", "kv"))
    dense_bf16_case("o decode M=3 2048->2048 +add", 3, 2048, 2048, bias=False, add=True,
                    role=("decode", "o"))
    dense_bf16_case("down decode M=3 11008->2048 +add", 3, 11008, 2048, bias=False, add=True,
                    role=("decode", "down"))
    dense_bf16_case("q prefill M=48 2048->2048 +bias", 48, 2048, 2048, pipelined=True,
                    role=("prefill", "q"))
    dense_bf16_case("k/v prefill M=48 2048->256 +bias", 48, 2048, 256, role=("prefill", "kv"))
    dense_bf16_case("o prefill M=48 2048->2048 +add", 48, 2048, 2048, bias=False, add=True,
                    role=("prefill", "o"))
    dense_bf16_case("down prefill M=48 11008->2048 +add", 48, 11008, 2048, bias=False, add=True,
                    role=("prefill", "down"))
    dense_bf16_case("M=5 K=70 N=50 +add (ragged)", 5, 70, 50, add=True)
    # odd K and N: bf16 rows not 4-byte aligned, staged by element loads
    # (the mma_gemm.cuh body: TMA cannot address them)
    dense_bf16_case("M=20 K=71 N=51 +add (odd K, N)", 20, 71, 51, add=True, pipelined=True)
    # K ends inside a BK = 128 slab of the wgmma body (TMA's zero fill past
    # K), still bit-equal across tiles and depths
    dense_bf16_case("M=48 K=2112 N=256 +bias (K ends in a slab)", 48, 2112, 256, pipelined=True)
    # granite-3-2b (head dim 64, 32 / 8 heads) and phi4-mini-3.8b (head dim
    # 128, 24 / 8 heads: 3 query heads a KV group) at the rows they are
    # served with: decode M = 3, prefill M = 48 (3 prompts padded to 16)
    from repro_torch.configs import get_config

    for arch in NEW_DECODERS:
        c = get_config(arch)
        d, dh, h, g, f = c.d_model, c.resolved_head_dim, c.n_heads, c.n_kv_heads, c.d_ff
        tag = arch.split("-")[0]
        t = per_arch[arch] = {"prefill": {}, "decode": {}}
        flash_case(f"{tag} decode q bf16 kv f32 B3 H{h}/G{g} d{dh} span1024 +len", 3, h, g, 1,
                   1024, dh, [1000, 517, 64], False, bf16, f32)
        t["decode"]["flash"] = results["flash_attention"][-1]["ms"]
        flash_case(f"{tag} prefill bf16 B3 H{h}/G{g} d{dh} S48 causal +len", 3, h, g, 48, 48, dh,
                   [48, 33, 17], True, bf16, bf16)
        t["prefill"]["flash"] = results["flash_attention"][-1]["ms"]
        for phase, m in (("decode", 3), ("prefill", 48)):
            for role, k, n, add in (("q", d, h * dh, False), ("kv", d, g * dh, False),
                                    ("o", h * dh, d, True), ("down", f, d, True)):
                dense_bf16_case(f"{tag} {role} {phase} M={m} {k}->{n}" + (" +add" if add else ""),
                                m, k, n, bias=c.qkv_bias and not add, add=add)
                t[phase][role] = results["dense_matmul_bf16"][-1]["ms"]
            ffn_case(f"{tag} {phase} M={m} K={d} F={f} bf16 silu", m, d, f, bf16)
            t[phase]["ffn"] = results["ffn_gateup"][-1]["ms"]
    # device ms of one plan call's GEMM launches: per layer q, k, v, o, down
    # (5 dense_matmul) and one ffn_gateup, over qwen2.5-3b's 36 layers
    # flash attention a plan call: the served prefill (S16 + lengths) and
    # the decode span of the headline case, once a layer
    t_flash = {r["label"]: r["ms"] for r in results["flash_attention"]}
    per_call["prefill"]["flash"] = t_flash["prefill bf16 B3 H16/G2 S16 causal +len"]
    per_call["decode"]["flash"] = t_flash["decode q bf16 kv f32 B3 H16/G2 span1024 +len"]
    per_arch["qwen2.5-3b"] = per_call
    for arch, calls in per_arch.items():
        layers = get_config(arch).n_layers
        for phase, t in calls.items():
            dense = layers * (t["q"] + 2 * t["kv"] + t["o"] + t["down"])
            ffn = layers * t["ffn"]
            flash = layers * t["flash"]
            print(f"  {arch} per {phase} plan call ({layers} layers, device ms x launches): "
                  f"dense_matmul_bf16 {5 * layers} launches {dense:.3f} ms, ffn_gateup "
                  f"{layers} launches {ffn:.3f} ms, together {dense + ffn:.3f} ms; "
                  f"flash_attention {layers} launches {flash:.3f} ms")
    phase_bsr_kernels(torch, record, results)
    torch.cuda.synchronize()
    return results


def phase_bsr_kernels(torch, record, results):
    """The block-sparse kernel against its plain version: the full-width
    pruned q / o projections (qwen2.5-3b, ``Block(0.5, bm=64, bn=64)``
    balanced, packed on the card) at decode and prefill, then f32 cases with
    bands, pads and an empty band.  Each band is one wrapper call writing
    into one output, as ``ops.bsr_matmul`` makes them.  Bound: the real
    blocks' bytes + block_rows + x + out + bias + sides, and
    2 * M * bm * bn per real block.  Each case prints its route and split
    per band (``bsr_matmul.plan``); bf16 edge cases drive every route
    (``route_launches``: wgmma, stream, cuda_core) and the wgmma route's
    other instances (32-row and 128-row slabs, 32-column tiles, pads, two
    M tiles, an empty band).  Then the pruned decoder's device
    time per plan call in ``bsr_matmul`` (36 q + 36 o launches), and a
    check that no split launch allocated tile counters (the kernels reset
    the ones ``_build.split_counters`` keeps)."""
    from repro_torch.core.pruning import Block, project
    from repro_torch.core.sparse import PBCSR
    from repro_torch.kernels import _build
    from repro_torch.kernels import bsr_matmul as kbsr
    from repro_torch.kernels.ref import _ACT

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    bf16 = torch.bfloat16

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def banded(fn, x, values, rows, bias, sides, bands, epi, act):
        out = torch.empty((x.shape[0], values.shape[0] * values.shape[3]), dtype=x.dtype,
                          device=dev)
        for band in bands:
            fn(x, values, rows, bias, *sides, activation=act, epilogue=epi, band=band, out=out)
        return out

    def case(label, x, w, mask, bm, bn, bias=None, add=False, bands=None, act=None):
        f = PBCSR.from_dense(w, mask, bm, bn)
        values, rows = f.values, f.block_rows
        nb, s = rows.shape
        bands = bands or ((0, nb, s),)
        m, n = x.shape[0], nb * bn
        sides = (randn(m, n, dtype=x.dtype),) if add else ()
        epi = (("add", 0),) if add else ()
        args = (x, values, rows, bias, sides, bands, epi, act)
        plans = [kbsr.plan_for(x, values, stop - start, count) for start, stop, count in bands]
        print(f"  {'bsr_matmul':18s} {label:42s} route " + "; ".join(
            f"{p.route} ({p.width} wide) x{p.nsplit} split{'s' if p.nsplit > 1 else ''} of "
            f"{p.schunk} step{'' if p.schunk == 1 else 's'}" for p in plans))
        out = banded(kbsr.bsr_matmul, *args)
        want = banded(kbsr.bsr_matmul_plain, *args)
        live = torch.zeros_like(rows, dtype=torch.bool)
        for start, stop, count in bands:
            live[start:stop, :count] = True
        real = int(((rows >= 0) & live).sum())
        dense = f.to_dense()

        def library():
            y = torch.addmm(bias, x, dense) if bias is not None else torch.matmul(x, dense)
            y = _ACT[act](y)
            return y + sides[0] if add else y

        nb_bytes = real * bm * bn * values.element_size() + nbytes(rows, x, bias, *sides, out)
        peak = PEAK_BF16_FLOPS if x.dtype == bf16 else PEAK_F32_FLOPS
        record("bsr_matmul", label, out, want, lambda: banded(kbsr.bsr_matmul, *args),
               lambda: banded(kbsr.bsr_matmul_plain, *args), library, nb_bytes,
               2.0 * m * real * bm * bn, peak)
        return rows

    allocs, splits = _build.counter_allocations, kbsr.split_launches
    routes0 = dict(kbsr.route_launches)
    # full width: the headline (decode q) first
    w_q = randn(2048, 2048, scale=2048 ** -0.5, dtype=bf16)
    w_o = randn(2048, 2048, scale=2048 ** -0.5, dtype=bf16)
    blk = Block(0.5, bm=64, bn=64)
    m_q, m_o = project(w_q, blk)[1], project(w_o, blk)[1]
    b_q = randn(2048, scale=0.1, dtype=bf16)
    rows = case("q decode M=3 2048->2048 b64 S=16 +bias", randn(3, 2048, dtype=bf16), w_q, m_q,
                64, 64, bias=b_q)
    check(tuple(rows.shape) == (32, 16) and bool((rows >= 0).all()),
          f"bsr q: balanced packing {tuple(rows.shape)}")
    case("q prefill M=48 2048->2048 b64 S=16 +bias", randn(48, 2048, dtype=bf16), w_q, m_q,
         64, 64, bias=b_q)
    case("o decode M=3 2048->2048 b64 S=16 +add", randn(3, 2048, dtype=bf16), w_o, m_o, 64, 64,
         add=True)
    case("o prefill M=48 2048->2048 b64 S=16 +add", randn(48, 2048, dtype=bf16), w_o, m_o,
         64, 64, add=True)
    # device ms of one plan call's bsr_matmul launches: q and o in each of
    # qwen2.5-3b's 36 layers
    t = {r["label"].split(" M=")[0]: r["ms"] for r in results["bsr_matmul"]}
    for phase in ("prefill", "decode"):
        ms = LLM_LAYERS * (t[f"q {phase}"] + t[f"o {phase}"])
        print(f"  per pruned {phase} plan call ({LLM_LAYERS} layers, device ms x launches): "
              f"bsr_matmul {2 * LLM_LAYERS} launches {ms:.3f} ms")
    # bf16 edge shapes: bm = 16 blocks with pads (no wgmma slab: the CUDA
    # cores), 24-column blocks with pads at decode (streaming), 32 x 32
    # blocks in bands with an empty one and 128-row blocks over two M
    # tiles with pads (the wgmma route's 32-row and 128-row slabs)
    w3 = randn(192, 96, scale=192 ** -0.5, dtype=bf16)
    case("bf16 M=13 192->96 b16x32 pads +add", randn(13, 192, dtype=bf16), w3,
         project(w3, Block(0.5, bm=16, bn=32, balanced=False))[1], 16, 32, add=True)
    w4 = randn(256, 384, scale=256 ** -0.5, dtype=bf16)
    case("bf16 M=8 256->384 b32x24 pads +add", randn(8, 256, dtype=bf16), w4,
         project(w4, Block(0.5, bm=32, bn=24, balanced=False))[1], 32, 24, add=True)
    w5 = randn(256, 256, scale=256 ** -0.5, dtype=bf16)
    m5 = project(w5, Block(0.5, bm=32, bn=32, balanced=False))[1]
    s5 = int(PBCSR.from_dense(w5, m5, 32, 32).block_rows.shape[1])
    case("bf16 M=20 256->256 b32 3 bands, 1 empty", randn(20, 256, dtype=bf16), w5, m5, 32, 32,
         bias=randn(256, scale=0.1, dtype=bf16), act="gelu",
         bands=((0, 1, 0), (1, 5, min(2, s5)), (5, 8, s5)))
    w6 = randn(512, 256, scale=512 ** -0.5, dtype=bf16)
    case("bf16 M=70 512->256 b128x64 pads +add", randn(70, 512, dtype=bf16), w6,
         project(w6, Block(0.5, bm=128, bn=64, balanced=False))[1], 128, 64, add=True)
    unused = [r for r, n in kbsr.route_launches.items() if n == routes0[r]]
    check(not unused, f"bsr_matmul: routes {unused} not launched by the bf16 cases")
    # the test MLP's first layer (256 -> 512, Block(0.5, 128, 128,
    # balanced=False)), numpy-seeded so its pads are known: two bands over
    # the unpermuted packing, pads inside them, an add side
    rng = np.random.default_rng(SEED + 3)
    w1 = torch.from_numpy((rng.standard_normal((256, 512)) * 0.05).astype(np.float32)).to(dev)
    m1 = project(w1, Block(0.5, bm=128, bn=128, balanced=False))[1]
    s1 = int(PBCSR.from_dense(w1, m1, 128, 128).block_rows.shape[1])
    rows = case("f32 MLP l1 M=8 256->512 b128 2 bands +pad +add", randn(8, 256), w1, m1,
                128, 128, bias=randn(512, scale=0.1), add=True,
                bands=((0, 1, s1), (1, 4, s1)))
    check(bool((rows < 0).any()), "bsr MLP case: no pad in the packing")
    # an empty band: columns 0-1 keep nothing (the reorder pass's count-0 band)
    bmask = torch.tensor([[0, 0, 1, 1], [0, 0, 0, 1], [0, 0, 1, 1]], dtype=torch.float32,
                         device=dev)
    m2 = torch.kron(bmask, torch.ones((16, 24), device=dev))
    case("f32 M=5 48->96 b16x24 empty band +relu", randn(5, 48), randn(48, 96), m2, 16, 24,
         bias=randn(96), bands=((0, 2, 0), (2, 3, 2), (3, 4, 3)), act="relu")
    splits = kbsr.split_launches - splits
    check(splits > 0 and _build.counter_allocations == allocs,
          f"bsr_matmul: {_build.counter_allocations - allocs} counter buffers allocated over "
          f"{splits} split launches")
    print(f"  {'bsr_matmul':18s} {splits} split launches, 0 counter buffers allocated "
          f"(the kernels reset _build.split_counters' buffer)")


def serve_measured(torch, ops, plan, params, frames, app):
    """Serve ``frames`` through ``PlanServer(batch_size=BATCH)``: one warm-up
    run, then ``TIMING_REPS`` timed runs with every launch count and the
    fallback counter set to 0 just before them and read just after.
    Returns the last output, the median seconds per run, the launches by
    kernels-line entry, the number of plan calls, the peak allocated bytes
    and the serving function (for the profile line)."""
    from repro_torch.serving import PlanServer

    def serve():
        server = PlanServer(plan, params, BATCH, name=app)
        for f in frames:
            server.submit(f)
        out = server.close()
        torch.cuda.synchronize()
        return out, server.stats

    serve()  # warm-up: allocator, first launches
    ops.reset_kernel_launches()
    ops.reset_conv_fallbacks()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(TIMING_REPS):
        t0 = time.perf_counter()
        out, stats = serve()
        times.append(time.perf_counter() - t0)
    launches = main_path_launches(ops)
    counts = ops.kernel_launch_counts()
    fallbacks = ops.conv_fallback_counts()
    peak = torch.cuda.max_memory_allocated()
    check(stats["batches"] == 3 and stats["padded_frames"] == 2,
          f"{app}: served {stats}, want 3 chunks with 2 padded frames")
    check(sum(fallbacks.values()) == 0, f"{app}: conv fallbacks {fallbacks}")
    calls = stats["batches"] * TIMING_REPS
    return dict(out=out, sec=statistics.median(times), launches=launches, counts=counts,
                calls=calls, peak=peak, serve=serve)


def check_per_call(app, counts, calls, want):
    for name, n in want.items():
        check(counts[name] == n * calls,
              f"{app}: {name} launched {counts[name]} times over {calls} plan calls, "
              f"want {n} per call")


def phase_apps(torch, np):
    from repro_torch.core.graph import PassContext, PassManager, compile_plan
    from repro_torch.kernels import ops
    from repro_torch.models.cnn import APP_INPUT_CHANNELS, APPS, app_masks

    launches = {name: 0 for name in KERNELS}
    apps = {}
    rng = np.random.default_rng(SEED)
    for app, (n_nodes, n_conv, n_dense, n_fused) in EXPECTED.items():
        g = APPS[app](torch.Generator().manual_seed(SEED), base=BASE, device="cuda")
        masks, structures = app_masks(g, app, sparsity=0.5)
        ctx = PassContext(masks=masks, structures=structures)
        go = PassManager().run(g, ctx)
        check(len(go.nodes) == n_nodes, f"{app}: {len(go.nodes)} plan nodes, want {n_nodes}")
        plan = compile_plan(go, backend="kernel", device="cuda")
        ref_plan = compile_plan(go, backend="reference", device="cuda")
        c_in = APP_INPUT_CHANNELS[app]
        frames = torch.from_numpy(
            rng.standard_normal((FRAMES, c_in, SIZE, SIZE)).astype(np.float32)
        ).to("cuda")
        mem = plan.memory_estimate((BATCH, c_in, SIZE, SIZE))
        run = serve_measured(torch, ops, plan, go.params, frames, app)
        check_per_call(app, run["counts"], run["calls"], {
            "conv2d": n_conv, "dense_matmul": n_dense, "fused_elementwise": n_fused,
            "quant_matmul": 0})
        for name, n in run["launches"].items():
            launches[name] += n
        out = run["out"]
        want = torch.cat(
            [ref_plan(go.params, frames[i:i + BATCH]) for i in range(0, FRAMES, BATCH)]
        )
        check(tuple(out.shape) == tuple(want.shape), f"{app}: shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), f"{app}: non-finite output")
        err = (out - want).abs().max().item()
        tol = 1e-3 * max(1.0, want.abs().max().item())
        check(err <= tol, f"{app}: max|kernel plan - reference plan| {err} > {tol}")
        sec = run["sec"]
        print(f"  {app:16s} nodes={len(go.nodes)} per-call launches conv2d={n_conv} "
              f"dense_matmul={n_dense} fused_elementwise={n_fused} fallbacks=0 "
              f"out={tuple(out.shape)} max_err={err:.3e} (tol {tol:.1e}) "
              f"ms/frame={sec / FRAMES * 1e3:.3f} frames/s={FRAMES / sec:.1f} "
              f"(median of {TIMING_REPS} x {FRAMES} frames) "
              f"peak_alloc={run['peak'] / 1e6:.1f}MB est_peak_act@batch{BATCH}="
              f"{mem['peak_activation_bytes'] / 1e6:.1f}MB")
        profile_serving(torch, app, run["serve"])
        apps[app] = dict(go=go, frames=frames, ref_plan=ref_plan, ms_per_frame=sec / FRAMES * 1e3,
                         plan=plan, out=out)
    return launches, apps


def phase_int8(torch, np, apps):
    """The INT8 path of each app, on the f32 graphs phase 4 built."""
    from repro_torch.core.graph import PassContext, PassManager, compile_plan
    from repro_torch.kernels import ops
    from repro_torch.models.cnn import APP_ACT_SKIP, APP_INPUT_CHANNELS, APP_QUANT_SKIP
    from repro_torch.quant import calibrate_plan

    launches = {name: 0 for name in KERNELS}
    rng = np.random.default_rng(SEED + 1)
    for app, (schemes, conv_by_scheme, n_quant, n_dense, n_fused) in EXPECTED_INT8.items():
        go, frames, f32_plan = apps[app]["go"], apps[app]["frames"], apps[app]["ref_plan"]
        shape = (BATCH, APP_INPUT_CHANNELS[app], SIZE, SIZE)
        batches = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to("cuda")
                   for _ in range(2)]
        table = calibrate_plan(f32_plan, go.params, batches)
        gq = PassManager(("quantize",)).run(go, PassContext(
            calibration=table, quant_skip=APP_QUANT_SKIP[app], act_quant_skip=APP_ACT_SKIP[app]))
        got = {}
        for n in gq.nodes:
            if n.op in ("qconv2d", "qlinear"):
                got[(n.op, n.attrs["scheme"])] = got.get((n.op, n.attrs["scheme"]), 0) + 1
        check(got == schemes, f"{app}: quantized nodes {got}, want {schemes}")
        plan = compile_plan(gq, backend="quant", device="cuda")
        qref_plan = compile_plan(gq, backend="reference", device="cuda")

        run = serve_measured(torch, ops, plan, gq.params, frames, app)
        calls = run["calls"]
        check_per_call(app, run["counts"], calls, {
            "conv2d": sum(conv_by_scheme.values()), "quant_matmul": n_quant,
            "dense_matmul": n_dense, "fused_elementwise": n_fused})
        for scheme, n in conv_by_scheme.items():
            name = "conv2d" if scheme == "f32" else f"conv2d_{scheme}"
            check(run["launches"][name] == n * calls,
                  f"{app}: conv kernel launched {run['launches'][name]} times as {scheme} "
                  f"over {calls} plan calls, want {n} per call")
        for name, n in run["launches"].items():
            launches[name] += n

        # every quantized step: its kernel handler against its reference
        # handler on the same inputs (the values of one plan call)
        values = {}
        x = frames[:BATCH]
        plan.run_steps(gq.params, x, observer=values.__setitem__)
        ref_handlers = qref_plan._handlers
        step_err = 0.0
        for step in plan.steps:
            n = step.node
            if n.op not in ("qconv2d", "qlinear"):
                continue
            xs = [values[i] for i in n.inputs]
            y = plan._handlers[n.op](gq.params[n.name], xs, n.attrs, plan._rt)
            r = ref_handlers[n.op](gq.params[n.name], xs, n.attrs, qref_plan._rt)
            e = (y - r).abs().max().item()
            tol = 1e-3 * max(1.0, r.abs().max().item())
            check(e <= tol, f"{app}: step {n.name} ({n.attrs['scheme']}) kernel vs reference "
                            f"{e} > {tol}")
            step_err = max(step_err, e)
        del values

        out = run["out"]
        check(bool(torch.isfinite(out).all()), f"{app}: non-finite output")
        chunks = range(0, FRAMES, BATCH)
        qref = torch.cat([qref_plan(gq.params, frames[i:i + BATCH]) for i in chunks])
        f32 = torch.cat([f32_plan(go.params, frames[i:i + BATCH]) for i in chunks])
        check(tuple(out.shape) == tuple(qref.shape) == tuple(f32.shape),
              f"{app}: shape {tuple(out.shape)}")
        err_q = (out - qref).abs().max().item()
        # W8 keeps f32 activations: the plan is as close to its reference as
        # an f32 plan is.  W8A8 (coloring) may round an activation the other
        # way after a different f32 sum; its bound is the INT8 contract.
        rtol = 5e-2 if any(s == "w8a8" for _, s in schemes) else 1e-3
        tol_q = rtol * max(1.0, qref.abs().max().item())
        check(err_q <= tol_q, f"{app}: max|quant plan - quant reference plan| {err_q} > {tol_q}")
        err_f = (out - f32).abs().max().item()
        shp = (BATCH, *shape[1:])
        mem_f, mem_q = f32_plan.memory_estimate(shp), plan.memory_estimate(shp)
        sec = run["sec"]
        print(f"  {app:16s} int8 nodes={sum(schemes.values())} "
              f"schemes={ {f'{o}/{s}': k for (o, s), k in schemes.items()} } "
              f"per-call launches conv2d={conv_by_scheme} quant_matmul={n_quant} "
              f"dense_matmul={n_dense} fused_elementwise={n_fused} fallbacks=0 "
              f"step_max_err={step_err:.3e} max_err_vs_quant_ref={err_q:.3e} (tol {tol_q:.1e}) "
              f"max_err_vs_f32={err_f:.3e} weights {mem_f['param_bytes'] / 1e6:.3f}MB -> "
              f"{mem_q['param_bytes'] / 1e6:.3f}MB "
              f"({mem_f['param_bytes'] / mem_q['param_bytes']:.2f}x) "
              f"ms/frame={sec / FRAMES * 1e3:.3f} frames/s={FRAMES / sec:.1f} "
              f"(f32 plan {apps[app]['ms_per_frame']:.3f} ms/frame) "
              f"peak_alloc={run['peak'] / 1e6:.1f}MB")
        profile_serving(torch, app + " int8", run["serve"])
        apps[app].update(gq=gq, int8_plan=plan, int8_out=out, int8_ms=sec / FRAMES * 1e3)
    return launches


def phase_tune(torch, apps):
    """The tuning path on the card: ``launch/tune`` for the three apps with
    ``--quantize`` at the served shapes, then each app's f32 and INT8 plans
    (built by the apps and int8 phases from the same seed, so they resolve
    the same keys) served on the loaded winners and on depth-pinned
    entries.  Every serving's outputs must be ``torch.equal`` to the untuned
    plan's: every tile and depth sums each output in the same order."""
    import contextlib
    import io

    from repro_torch.kernels import _build, ops
    from repro_torch.launch import tune

    cache = ops.tuning_cache()
    out_dir = ROOT / "build" / "tune"
    path = out_dir / "tuning_cache.json"
    argv = ["--graph-app", "all", "--quantize", "--size", str(SIZE), "--base", str(BASE),
            "--batch", str(BATCH), "--seed", str(SEED), "--device", "cuda", "--out", str(path)]
    # the CLI as a fresh process runs it: from an empty cache (the earlier
    # phases recorded their keys' defaults)
    cache.clear()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        tune.main(argv)
    dt = time.perf_counter() - t0
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "report.txt").write_text(buf.getvalue())
    print(f"  python -m repro_torch.launch.tune {' '.join(argv)}: {dt:.1f}s "
          f"(report in {(out_dir / 'report.txt').relative_to(ROOT)})")
    print("  " + buf.getvalue().strip().splitlines()[-1])
    def default_tile(key):
        """The tile the wrapper would run for ``key`` untuned."""
        op, dims, _, fmt, _ = key.split("|")
        d = [int(v) for v in dims.split("x")]
        if op in ("matmul", "qmatmul"):
            return _build.gemm_default_tile(d[1])
        if op == "conv2d":  # fmt is {format}+{scheme}[+...]
            return _build.conv_default_tile(fmt.split("+")[1], d[4])
        return ops.TuningCache.CANDIDATES[op][0]

    fams = {}
    for key, e in cache.entries.items():
        op = key.split("|")[0]
        check(key.endswith("|sm90"), f"tune: key {key} is not an sm90 key")
        if op in ("matmul", "qmatmul", "conv2d"):
            check(e.source == "swept", f"tune: {key} was not swept ({e.source})")
        f = fams.setdefault(op, {"keys": 0, "depth>=2": 0, "not default": 0, "winners": {}})
        f["keys"] += 1
        tile = "x".join(map(str, e.blocks))
        f["winners"][tile] = f["winners"].get(tile, 0) + 1
        f["not default"] += tuple(e.blocks) != default_tile(key)
        if op in ("matmul", "qmatmul") and e.blocks[3] >= 2:
            f["depth>=2"] += 1
    for op, f in sorted(fams.items()):
        st = cache.stats.get(op, {})
        print(f"  tune {op}: {f['keys']} keys, {st.get('sweeps', 0)} sweeps, "
              f"{f['not default']} winners other than the default tile, {f['depth>=2']} "
              f"pipelined; winners by tile {f['winners']}")
    for op in ("matmul", "qmatmul", "conv2d"):
        check(fams.get(op, {}).get("keys", 0) > 0, f"tune: no {op} key")

    launches = {name: 0 for name in KERNELS}

    def serve_all(label, per_call_fn):
        """Serve every app's f32 and INT8 plans on the cache as it stands;
        outputs equal to the untuned plans', exact launches per call."""
        for app, (_, n_conv, n_dense, n_fused) in EXPECTED.items():
            a = apps[app]
            _, conv_by_scheme, n_quant, n_dense_q, n_fused_q = EXPECTED_INT8[app]
            variants = (
                ("f32", a["plan"], a["go"].params, a["out"], a["ms_per_frame"],
                 dict(conv2d=n_conv, dense=n_dense, quant=0, fused_elementwise=n_fused)),
                ("int8", a["int8_plan"], a["gq"].params, a["int8_out"], a["int8_ms"],
                 dict(conv2d=sum(conv_by_scheme.values()), dense=n_dense_q, quant=n_quant,
                      fused_elementwise=n_fused_q)),
            )
            for variant, plan, params, untuned, untuned_ms, n in variants:
                cache.stats.clear()
                run = serve_measured(torch, ops, plan, params, a["frames"], app)
                for fam in ("matmul", "qmatmul", "conv2d"):
                    misses = cache.stats.get(fam, {}).get("misses", 0)
                    check(misses == 0, f"{label} {app} {variant}: {misses} {fam} cache misses")
                check(torch.equal(run["out"], untuned),
                      f"{label} {app} {variant}: output differs from the untuned plan's")
                check_per_call(f"{label} {app} {variant}", run["counts"], run["calls"],
                               per_call_fn(n))
                for kind in ("dense", "quant"):  # each GEMM node: tiled or pipelined
                    c = run["counts"]
                    got = c[f"{kind}_matmul"] + c[f"{kind}_matmul_pipelined"]
                    check(got == n[kind] * run["calls"],
                          f"{label} {app} {variant}: {got} {kind} GEMM launches over "
                          f"{run['calls']} plan calls, want {n[kind]} per call")
                for name, k in run["launches"].items():
                    launches[name] += k
                counts = {k: v // run["calls"] for k, v in run["counts"].items() if v}
                ms = run["sec"] / FRAMES * 1e3
                print(f"  {label:9s} {app:16s} {variant:4s} ms/frame={ms:.3f} "
                      f"(untuned {untuned_ms:.3f}) per-call launches {counts} "
                      f"output torch.equal to the untuned plan's; cache misses 0")

    # 2. the loaded winners: the GEMM nodes run the tiled or the pipelined
    # kernel, whichever won
    cache.clear()
    cache.enabled = False
    cache.ops_filter = None
    cache.load(str(path))
    serve_all("tuned", lambda n: {
        "conv2d": n["conv2d"], "fused_elementwise": n["fused_elementwise"]})
    # 3. every matmul / qmatmul entry replaced by a depth-2, then a depth-3
    # tile: each GEMM node launches the pipelined kernel, none the tiled one
    for depth in (2, 3):
        cache.clear()
        cache.load(str(path))
        for key, e in cache.entries.items():
            if key.split("|")[0] in ("matmul", "qmatmul"):
                e.blocks = (64, 64, 16, depth)
        serve_all(f"depth {depth}", lambda n: {
            "conv2d": n["conv2d"], "fused_elementwise": n["fused_elementwise"],
            "dense_matmul": 0, "dense_matmul_pipelined": n["dense"],
            "quant_matmul": 0, "quant_matmul_pipelined": n["quant"]})
    # 4. back to no tuning and an empty cache
    cache.clear()
    cache.enabled = False
    return launches


#: the async serving phase: frames an app, submitted to each of its plans
#: (f32 and INT8), the tenants (name, weight, quota in requests/s), the
#: partial-batch release deadline and the watchdog of its watchdog check
ASYNC_FRAMES = 24
ASYNC_TENANTS = (("gold", 3.0, 200.0), ("free", 1.0, 50.0))
ASYNC_FLUSH = 0.005
ASYNC_WATCHDOG = 0.5


def phase_serve_async(torch, np, apps):
    """The frame side of ``AsyncPlanServer`` and the guarded backend at full
    width, on the plans the apps and int8 phases built (see the module
    doc, phase 6).  Returns the launches of the zero-fault serving run."""
    from repro_torch.core.graph import compile_plan
    from repro_torch.kernels import _build, ops
    from repro_torch.models.cnn import APP_INPUT_CHANNELS
    from repro_torch.robustness import FaultPlan, FaultRule, GuardConfig
    from repro_torch.serving import (
        AsyncPlanServer,
        QuotaExceededError,
        SwapError,
        WatchdogTimeout,
    )

    rng = np.random.default_rng(SEED + 2)
    frames = {app: torch.from_numpy(rng.standard_normal(
        (ASYNC_FRAMES, APP_INPUT_CHANNELS[app], SIZE, SIZE)).astype(np.float32)).to("cuda")
        for app in apps}
    #: plan name -> its app, plan, params, graph, reference plan and the
    #: tolerance of the plan against it (phase 5's: W8A8 to 5e-2)
    plans = {}
    for app, a in apps.items():
        plans[app] = dict(app=app, plan=a["plan"], params=a["go"].params, graph=a["go"],
                          ref=a["ref_plan"], rtol=1e-3)
        plans[app + "_int8"] = dict(
            app=app, plan=a["int8_plan"], params=a["gq"].params, graph=a["gq"],
            ref=compile_plan(a["gq"], backend="reference", device="cuda"),
            rtol=5e-2 if app == "coloring" else 1e-3)
    chunks = {name: [frames[e["app"]][i:i + BATCH] for i in range(0, ASYNC_FRAMES, BATCH)]
              for name, e in plans.items()}

    def recorded(run, name, record):
        def run_chunk(params, *xs):
            out = run(params, *xs)
            record.append((name, xs[0], out))
            return out
        return run_chunk

    def serve(which, tenants=(), record=None, **kw):
        """A fresh ``AsyncPlanServer`` over ``which`` (name -> plan), its
        scheduler thread started; every frame of each app submitted to each
        of its plans from this thread, the tenants in turn, a throttled
        submit tried again after 5 ms.  ``record`` collects every chunk the
        scheduler runs as (plan name, inputs, output)."""
        server = AsyncPlanServer(flush_after=ASYNC_FLUSH, **kw)
        for name, weight, rate in tenants:
            server.add_tenant(name, weight=weight, rate=rate)
        for name, plan in which.items():
            e = plans[name]
            server.add_plan(name, plan, e["params"], BATCH,
                            input_spec=[(tuple(frames[e["app"]].shape[1:]), torch.float32)])
            if record is not None:  # the scheduler's chunks, as it ran them
                bp = server._plans[name].batched
                bp.run_chunk = recorded(bp.run_chunk, name, record)
        handles, attempts, throttled = [], 0, 0
        with server:
            server.start()
            t0 = time.perf_counter()
            for i in range(ASYNC_FRAMES):
                for name in which:
                    tenant = tenants[len(handles) % len(tenants)][0] if tenants else None
                    while True:
                        attempts += 1
                        try:
                            h = server.submit(name, frames[plans[name]["app"]][i],
                                              tenant=tenant)
                            break
                        except QuotaExceededError:
                            throttled += 1
                            time.sleep(0.005)
                    handles.append((name, i, h))
            for _, _, h in handles:
                h.result(120)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            stats, health = server.stats, server.health()
        if record is not None:  # the recorder and its chunk plan form a cycle
            for name in which:
                del server._plans[name].batched.run_chunk
        return dict(handles=handles, attempts=attempts, throttled=throttled, sec=sec,
                    stats=stats, health=health)

    def fallbacks(gplans):
        return sum(p.guard_stats()["counters"]["fallbacks"] for p in gplans.values())

    kernel_plans = {name: e["plan"] for name, e in plans.items()}
    n_req = len(plans) * ASYNC_FRAMES

    # 1. zero faults: the f32 and INT8 plans of every app, two tenants
    print(f"  1. {len(plans)} plans (f32 + INT8 of each app), batch {BATCH}, flush_after "
          f"{ASYNC_FLUSH}s, tenants " + ",".join(f"{n}:{w:g}:{r:g}" for n, w, r in ASYNC_TENANTS)
          + f"; {ASYNC_FRAMES} frames an app to each of its plans ({n_req} requests)")
    serve(kernel_plans, ASYNC_TENANTS)  # warm-up: allocator, first launches
    record = []
    ops.reset_kernel_launches()
    run = serve(kernel_plans, ASYNC_TENANTS, record=record)
    launches = main_path_launches(ops)
    st = run["stats"]
    shed = st["shed"] + sum(t["ladder_shed"] for t in st["per_tenant"].values())
    throttled = sum(t["throttled"] for t in st["per_tenant"].values())
    check(throttled == run["throttled"], f"async: {throttled} throttles counted, "
                                         f"{run['throttled']} seen")
    check(st["completed"] + throttled + shed == run["attempts"] and st["completed"] == n_req
          and st["submitted"] == n_req,
          f"async: {run['attempts']} submits, completed {st['completed']} + throttled "
          f"{throttled} + shed {shed}")
    check(all(h.exception() is None for _, _, h in run["handles"]), "async: a request failed")
    # every served output is the plan's own output on the batch the
    # scheduler formed: each recorded chunk run again directly, bit for bit
    where = {}
    for c, (name, x, out) in enumerate(record):
        again = plans[name]["plan"].batched(BATCH).run_chunk(plans[name]["params"], x)
        check(torch.equal(again, out), f"async: {name} chunk {c} differs when run again")
        for row, key in enumerate(x.flatten(1)[:, :4].tolist()):
            where[(name, tuple(key))] = (again, row)
    for name, i, h in run["handles"]:
        again, row = where[(name, tuple(frames[plans[name]["app"]][i].flatten()[:4].tolist()))]
        check(torch.equal(h.result(), again[row]), f"async: {name} frame {i} is not its batch's")
    check(sum(launches.values()) > 0, "async: no kernel launched")
    batches = st["batches"]
    print(f"     {n_req} requests in {run['sec']:.3f}s ({run['sec'] / n_req * 1e3:.3f} ms/frame, "
          f"quota-paced); {run['attempts']} submits = {st['completed']} completed + {throttled} "
          f"throttled + {shed} shed; {batches} batches ({st['padded_frames']} padded frames, "
          f"{st['deadline_flushes']} flush_after releases); every output torch.equal to its "
          f"plan run again on the batch the scheduler formed ({len(record)} chunks)")
    for name, _, _ in ASYNC_TENANTS:
        lats = np.asarray([h.latency for _, _, h in run["handles"] if h.tenant == name])
        t = st["per_tenant"][name]
        print(f"     tenant {name}: {lats.size} requests p50={np.percentile(lats, 50) * 1e3:.3f}ms "
              f"p95={np.percentile(lats, 95) * 1e3:.3f}ms p99={np.percentile(lats, 99) * 1e3:.3f}ms "
              f"throttled={t['throttled']} completed={t['completed']}")
    profile_serving(torch, "serve async (no tenants)", lambda: serve(kernel_plans))

    # 2. guarded plans: 0% (ms/frame beside the kernel plans'), 100%, 5%
    guarded = {name: compile_plan(e["graph"], backend="guarded", device="cuda",
                                  guard=GuardConfig(breaker_threshold=100))
               for name, e in plans.items()}
    timing = {"kernel": [], "guarded": []}
    for which in ("kernel", "guarded", "guarded", "kernel"):
        r = serve(kernel_plans if which == "kernel" else guarded)
        check(all(h.exception() is None for _, _, h in r["handles"]), f"{which}: failed")
        timing[which].append(r["sec"] / n_req * 1e3)
    check(fallbacks(guarded) == 0, f"guarded at 0% faults: {fallbacks(guarded)} demotions")
    demotable = {}
    for name, g in guarded.items():
        e = plans[name]
        ok0 = g.guard_stats()["counters"]["primary_ok"]
        for x in chunks[name]:
            check(torch.equal(g(e["params"], x), e["plan"](e["params"], x)),
                  f"guarded {name} at 0% faults differs from its kernel plan")
        demotable[name] = (g.guard_stats()["counters"]["primary_ok"] - ok0) // len(chunks[name])
    print(f"     2. guarded at 0% faults: 0 demotions, every chunk torch.equal to the kernel "
          f"plans; ms/frame through AsyncPlanServer (no tenants; kernel, guarded, guarded, "
          f"kernel): kernel {' '.join(f'{v:.3f}' for v in timing['kernel'])} guarded "
          f"{' '.join(f'{v:.3f}' for v in timing['guarded'])}; demotable steps "
          + " ".join(f"{n}={k}" for n, k in demotable.items()))
    with FaultPlan([FaultRule("*", "raise", rate=1.0)], seed=7):
        for name, g in guarded.items():
            e = plans[name]
            before = g.guard_stats()["counters"]["fallbacks"]
            for x in chunks[name]:
                check(torch.equal(g(e["params"], x), e["ref"](e["params"], x)),
                      f"guarded {name} at 100% faults differs from the reference plan")
            got = g.guard_stats()["counters"]["fallbacks"] - before
            check(got == demotable[name] * len(chunks[name]),
                  f"guarded {name} at 100%: {got} demotions over {len(chunks[name])} calls, "
                  f"want {demotable[name]} a call")
    # breakers trip under sustained failure and recover on an injected clock
    clk = [0.0]
    tripping = {name: compile_plan(e["graph"], backend="guarded", device="cuda",
                                   guard=GuardConfig(breaker_threshold=3, breaker_cooldown=5.0,
                                                     clock=lambda: clk[0]))
                for name, e in plans.items()}
    with FaultPlan([FaultRule("*", "raise", rate=1.0)], seed=7):
        for name, g in tripping.items():
            g(plans[name]["params"], chunks[name][0])
    trips = {name: sum(b["trips"] for b in g.guard_stats()["breakers"].values())
             for name, g in tripping.items()}
    check(all(trips.values()), f"breakers: trips {trips}")
    clk[0] += 5.0
    for name, g in tripping.items():
        e = plans[name]
        check(torch.equal(g(e["params"], chunks[name][0]), e["plan"](e["params"],
                                                                      chunks[name][0])),
              f"{name}: recovered plan differs from the kernel plan")
        states = {b["state"] for b in g.guard_stats()["breakers"].values()}
        check(states == {"closed"}, f"{name}: breakers {states} after the cooldown")
    # fresh plans: the 100% runs' failures still sit in the breakers' window
    # (30 s of wall clock), so more would open them and add demotions that
    # no injection caused
    sparse = {name: compile_plan(e["graph"], backend="guarded", device="cuda",
                                 guard=GuardConfig(breaker_threshold=100))
              for name, e in plans.items()}
    with FaultPlan([FaultRule("*", "raise", rate=0.05)], seed=7) as fp:
        r = serve(sparse)
    worst = 0.0
    for name, i, h in r["handles"]:
        e = plans[name]
        check(h.exception() is None, f"guarded 5%: {name} frame {i} failed")
        want = e["ref"](e["params"], frames[e["app"]][i:i + 1])[0]
        err = (h.result() - want).abs().max().item()
        tol = e["rtol"] * max(1.0, want.abs().max().item())
        check(err <= tol, f"guarded 5%: {name} frame {i} {err} > {tol}")
        worst = max(worst, err / tol)
    demoted = fallbacks(sparse)
    check(fp.injection_count() > 0 and demoted == fp.injection_count(),
          f"guarded 5%: {demoted} demotions, {fp.injection_count()} injections")
    print(f"     guarded at 100% faults: every chunk torch.equal to the reference plans, "
          f"demotions = demotable steps x calls; breakers tripped ({trips}) and closed after "
          f"the cooldown on an injected clock; at a seeded 5%: {n_req} requests completed, "
          f"{demoted} demotions = {fp.injection_count()} injections, worst error "
          f"{worst:.3f} of the tolerance")

    # 3. a corrupted tuning cache: the kernel plan raises, the guarded plan
    # demotes (every key the plans resolve was recorded by the runs above)
    cache = ops.tuning_cache()
    n_keys = len(cache.entries)
    with FaultPlan([FaultRule("*", "cache_corrupt", rate=1.0)], seed=0) as fp:
        check(len(fp.corrupted_keys) == n_keys > 0, "cache_corrupt: no keys")
        for name, e in plans.items():
            x = chunks[name][0]
            try:
                e["plan"](e["params"], x)
                torch.cuda.synchronize()
                check(False, f"cache_corrupt: the {name} kernel plan did not raise")
            except _build.TileError:
                pass
            before = guarded[name].guard_stats()["counters"]["fallbacks"]
            check(torch.equal(guarded[name](e["params"], x), e["ref"](e["params"], x)),
                  f"cache_corrupt: guarded {name} differs from the reference plan")
            check(guarded[name].guard_stats()["counters"]["fallbacks"] - before
                  == demotable[name], f"cache_corrupt: {name} did not demote every step")
    cache.clear()
    print(f"     3. cache_corrupt: {n_keys} keys zeroed; each kernel plan raised TileError, "
          f"each guarded plan demoted every kernel step and was torch.equal to the "
          f"reference plan; cache cleared")

    # 4. hot swap f32 -> INT8 under load, a rollback, the watchdog
    f32 = {app: plans[app] for app in apps}
    server = AsyncPlanServer(flush_after=ASYNC_FLUSH)
    for app, e in f32.items():
        server.add_plan(app, e["plan"], e["params"], BATCH,
                        input_spec=[(tuple(frames[app].shape[1:]), torch.float32)])
    half = ASYNC_FRAMES // 2
    with server:
        server.start()
        hs = [(app, i, server.submit(app, frames[app][i])) for i in range(half) for app in f32]
        for app in f32:  # swap while that traffic is queued or running
            q = plans[app + "_int8"]
            check(server.swap_plan(app, q["plan"], q["params"],
                                   probe_frames=[frames[app][0]]) == 1, f"swap {app}")
        hs += [(app, i, server.submit(app, frames[app][i]))
               for i in range(half, ASYNC_FRAMES) for app in f32]
        versions = [h._runner.version for _, _, h in hs]
        nan_params = {n: {k: v * float("nan") if v.is_floating_point() else v
                          for k, v in p.items()} for n, p in f32["coloring"]["params"].items()}
        try:
            server.swap_plan("coloring", f32["coloring"]["plan"], nan_params,
                             probe_frames=[frames["coloring"][0]])
            check(False, "swap: a NaN version installed")
        except SwapError as err:
            check("non-finite" in str(err), f"swap: {err}")
        for _, _, h in hs:
            h.result(120)
        server.close()
        swap_stats, health = server.stats, server.health()
    for (app, i, h), v in zip(hs, versions):
        e = plans[app if v == 0 else app + "_int8"]
        want = e["ref"](e["params"], frames[app][i:i + 1])[0]
        tol = e["rtol"] * max(1.0, want.abs().max().item())
        check(h.exception() is None and (h.result() - want).abs().max().item() <= tol,
              f"swap: {app} frame {i} on v{v}")
    check(swap_stats["completed"] == swap_stats["submitted"] == len(hs)
          and swap_stats["swaps"] == 3 and swap_stats["versions_retired"] == 3
          and swap_stats["swap_rollbacks"] == 1
          and all(p["version"] == 1 and "draining" not in p for p in health["plans"].values()),
          f"swap: stats {swap_stats}")
    check({0, 1} <= set(versions), f"swap: versions served {set(versions)}")
    e = plans["style_transfer"]
    server = AsyncPlanServer(watchdog=ASYNC_WATCHDOG)
    server.add_plan("st", e["plan"], e["params"], BATCH)
    warm = [server.submit("st", x) for x in chunks["style_transfer"][0]]
    server.step(force=True)
    release = threading.Event()
    fp = FaultPlan([FaultRule("conv2d", "latency", rate=1.0, delay=2 * ASYNC_WATCHDOG)],
                   seed=0, sleep=release.wait).install()
    try:
        slow = [server.submit("st", x) for x in chunks["style_transfer"][1]]
        server.step(force=True)
    finally:
        release.set()
        fp.uninstall()
    time.sleep(0.2)  # the abandoned batch finishes late: its verdict stands
    nxt = [server.submit("st", x) for x in chunks["style_transfer"][2]]
    server.step(force=True)
    server.close()
    check(all(h.exception() is None for h in warm + nxt)
          and all(isinstance(h.exception(), WatchdogTimeout) for h in slow)
          and server.stats["watchdog_timeouts"] == 1,
          f"watchdog: {[type(h.exception()).__name__ for h in warm + slow + nxt]}")
    print(f"     4. hot swap f32 -> INT8 under load: {len(hs)} requests, "
          f"{versions.count(0)} on v0 and {versions.count(1)} on v1, zero lost, 3 swaps, 3 "
          f"versions retired, a NaN version rolled back; watchdog {ASYNC_WATCHDOG}s: the "
          f"batch under a {2 * ASYNC_WATCHDOG}s latency fault failed (WatchdogTimeout), the "
          f"next completed")
    # 5. guarded decode at the smoke config (the llm smoke phase serves the
    # kernel plans again)
    import argparse

    from repro_torch.launch import serve as serve_cli

    args = argparse.Namespace(smoke=True, **LLM_ARGS)
    llm = serve_cli.build_llm(args, torch.device("cuda"))
    guarded_decode(torch, llm, args, f"   5. {llm['cfg'].name}")
    return launches


#: kernel-name fragments of the port's own kernels
_OWN = {"conv2d_igemm": "conv2d", "simt_gemm_kernel<float": "dense_matmul",
        "BsrWalk": "bsr_matmul", "RowEpilogue": "dense_matmul", "fused_ew": "fused_elementwise",
        "simt_gemm_kernel<signed char": "quant_matmul", "int8_gemm_kernel": "quant_matmul",
        "ffn_gateup_simt_kernel": "ffn_gateup", "ffn_gateup_skinny_kernel": "ffn_gateup",
        "GateUpEpilogue": "ffn_gateup",
        "bsr_matmul": "bsr_matmul", "Memcpy": "memcpy"}
#: the conv kernel's first template argument is its scheme (csrc/scheme.cuh)
_CONV_SCHEME = {"0": "conv2d", "1": "conv2d_w8", "2": "conv2d_w8a8"}


#: flash attention's kernels by route (csrc/flash_attention.cu; the split
#: route's combine kernel belongs to it)
_FLASH_ROUTES = {"split": "split", "combine": "split", "tc": "tensor_core", "simt": "simt"}


def _family(key: str) -> str:
    m = re.search(r"flash_attention_(split|combine|tc|simt)_kernel", key)
    if m:
        return "flash_attention/" + _FLASH_ROUTES[m.group(1)]
    name = next((v for k, v in _OWN.items() if k in key), None)
    if name == "conv2d":  # conv2d_igemm_kernel<S, ...> or conv2d_igemm_int8_kernel<S, ...>
        m = re.search(r"conv2d_igemm\w*<(\d)", key)
        return _CONV_SCHEME.get(m.group(1) if m else "", name)
    return name or "other:" + key.split("(")[0].split("<")[0][:48]


def profile_serving(torch, app, serve, top_n=6):
    """Where one serving run's device time goes (torch.profiler): device
    time per kernel family, and the device's idle share of the wall time
    (inflated by the profiler's own host overhead).  Returns the numbers."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for _ in range(PROFILE_ATTEMPTS):  # a session may see no device events
        with profile(activities=activities, acc_events=True) as prof:
            t0 = time.perf_counter()
            serve()
            wall_us = (time.perf_counter() - t0) * 1e6
        by = {}
        for e in prof.key_averages():
            # device-side kernel events only: a host op's entry repeats the
            # device time of the kernels it launched
            us = e.self_device_time_total
            if e.device_type != torch.autograd.DeviceType.CUDA or us <= 0:
                continue
            name = _family(e.key)
            by[name] = by.get(name, 0.0) + us
        busy = sum(by.values())
        if busy > 0:
            break
    check(busy > 0, f"{app}: the profiler saw no device time")
    top = sorted(by.items(), key=lambda kv: -kv[1])[:top_n]
    parts = " ".join(f"{k}={v / 1e3:.3f}ms({v / busy:.0%})" for k, v in top)
    plain = sum(v for k, v in by.items() if k.startswith("other:"))
    print(f"    profile {app}: device {busy / 1e3:.3f}ms of wall {wall_us / 1e3:.3f}ms "
          f"(idle {1 - busy / wall_us:.0%}) {parts}; plain torch {plain / 1e3:.3f}ms "
          f"({plain / busy:.0%})")
    return dict(busy_us=busy, wall_us=wall_us, by=by)


def phase_llm(torch, smoke: bool, block=None, arch=LLM_ARGS["arch"]):
    """The port's ``serve --llm`` path on the card (``repro_torch.launch.
    serve``'s functions, as the CLI runs them): ``arch`` at full width in
    bf16, or its smoke config in f32; weights from a CUDA generator seeded
    with SEED.  With ``block`` (a ``Block`` structure) the same params then
    serve again block-pruned on every q / o projection (see
    :func:`block_pruned_llm`); the full-width pruned run prints its own
    phase header.  Full-width qwen2.5-3b also serves its plans guarded and
    profiles one prefill and one decode plan call (:func:`profile_llm`).
    Returns the launches of both runs, summed."""
    import argparse

    from repro_torch.launch import serve

    args = argparse.Namespace(smoke=smoke, **{**LLM_ARGS, "arch": arch})
    dev = torch.device(args.device)
    t0 = time.perf_counter()
    llm = serve.build_llm(args, dev)
    torch.cuda.synchronize()
    cfg = llm["cfg"]
    param_b = plan_param_bytes(*llm["plans"].values())
    print(f"  {cfg.name} {cfg.dtype}: {cfg.n_layers} layers d_model={cfg.d_model} "
          f"heads={cfg.n_heads}/{cfg.n_kv_heads} d_ff={cfg.d_ff} vocab={cfg.vocab} "
          f"params={param_b / 1e9:.3f}GB built in {time.perf_counter() - t0:.1f}s")
    dense = "dense_matmul" if smoke else "dense_matmul_bf16"
    launches, dense_peak = serve_llm_checked(torch, llm, args, smoke, cfg.name,
                                             {dense: 5 * cfg.n_layers})
    if not smoke and arch == LLM_ARGS["arch"]:
        # the smoke decoder runs guarded in the serve async phase; the other
        # full-width decoders leave the guarded repeat to qwen2.5-3b
        guarded_decode(torch, llm, args, cfg.name)
        profile_llm(torch, llm, args)
    if block is not None:
        if not smoke:
            print(f"== llm block-pruned ({cfg.name}, full width, bf16)")
        t0 = time.perf_counter()
        pruned = block_pruned_llm(torch, llm, block)
        torch.cuda.synchronize()
        dense_b = sum(nbytes(lp["attn"]["w_q"]["w"], lp["attn"]["w_o"]["w"])
                      for lp in llm["params"]["layers"])
        # the dense model goes before the pruned one serves: its plans and
        # its q / o weights (the pruned plans share every other tensor), so
        # the pruned run's peak is the pruned plans' own
        del llm
        torch.cuda.empty_cache()
        graph = pruned["plans"]["decode"].graph
        pbcsr = [n for n in graph.nodes
                 if n.op == "sparse_linear" and n.attrs["format"] == "pbcsr"]
        glue = [n.name for n in graph.nodes if n.name.endswith("_unperm")]
        n_bands = sum(len(n.attrs["bands"]) for n in pbcsr)
        check(len(pbcsr) == 2 * cfg.n_layers, f"pruned llm: {len(pbcsr)} pbcsr nodes")
        # the packed q / o weights as the device holds them (pads included)
        packed = sum(nbytes(graph.params[n.name]["values"], graph.params[n.name]["block_rows"])
                     for n in pbcsr)
        blocks = sum(int((graph.params[n.name]["block_rows"] >= 0).sum()) for n in pbcsr)
        pruned_b = plan_param_bytes(*pruned["plans"].values())
        print(f"  {block}: {len(pbcsr)} pbcsr nodes, {n_bands} bands, {len(glue)} unperm glue "
              f"nodes; q/o weights {dense_b / 1e6:.3f}MB dense -> {packed / 1e6:.3f}MB packed "
              f"({blocks} blocks); pruned plans' params {pruned_b / 1e9:.3f}GB (dense "
              f"{param_b / 1e9:.3f}GB); pruned in {time.perf_counter() - t0:.1f}s")
        # the params memory_estimate counts lose at most the q / o bytes the
        # packing saves (the bands' unperm glue, where there is any, adds
        # its index tensors)
        check(0 < param_b - pruned_b <= dense_b - packed,
              f"pruned llm: plan params {pruned_b} B against dense {param_b} B, q/o "
              f"{dense_b} B -> {packed} B")
        if not smoke:  # the paper's balanced recipe: one band a node, no glue,
            # at most half the dense bytes + one int32 per kept block
            check(n_bands == 2 * cfg.n_layers and not glue,
                  f"pruned llm: {n_bands} bands, glue {glue[:4]}")
            check(packed <= 0.5 * dense_b + 4 * blocks,
                  f"pruned llm: q/o packed {packed} B > half of dense {dense_b} B + 4 B/block")
        else:  # the unbalanced smoke variant runs bands, glue and a lone rope
            check(n_bands > len(pbcsr) and glue and any(
                n.op == "rope" for n in graph.nodes), "pruned llm smoke: no bands / glue")
        per_call = {dense: 3 * cfg.n_layers, "bsr_matmul": n_bands}
        pruned_launches, pruned_peak = serve_llm_checked(
            torch, pruned, args, smoke, f"{cfg.name} pruned", per_call, n_glue=len(glue))
        for name, n in pruned_launches.items():
            launches[name] += n
        if not smoke:  # at full width the halved q / o bytes show in the peak
            check(pruned_peak < dense_peak,
                  f"pruned llm: peak {pruned_peak} B, dense {dense_peak} B")
        del pruned
    else:
        del llm
    torch.cuda.empty_cache()
    return launches


def guarded_decode(torch, llm, args, label):
    """The decoder's graphs compiled for the ``guarded`` backend (the same
    weights), served through ``submit_llm`` beside ``llm``'s kernel plans,
    each once to warm up and once timed: no demotion at 0% faults, no
    failed sequence, no leaked page, ms per decode step and per prefill of
    each (the guarded plan checks every step's output for NaN / Inf, a host
    sync a step).  In f32 (the smoke config) the guarded plans' tokens must
    equal the kernel plans' at 0% faults and, at 100% ``raise``, the
    ``reference`` plans'; in bf16, where a batch formed another way may
    break a near-tie the other way, each sequence must pass the kernel
    plans' parity rule against the plain ``forward``
    (``serve.greedy_parity``)."""
    from repro_torch.core.graph import compile_plan
    from repro_torch.launch import serve
    from repro_torch.robustness import FaultPlan, FaultRule

    exact = llm["cfg"].dtype != "bfloat16"
    prompts = serve.llm_prompts(args, llm["cfg"])
    plans = {"kernel": llm["plans"]}
    for b in ("guarded", "reference") if exact else ("guarded",):
        plans[b] = {ph: compile_plan(g, backend=b, device=llm["device"])
                    for ph, g in llm["graphs"].items()}
    runs = {}
    for name, which in plans.items():
        serve.serve_llm_traffic(dict(llm, plans=which), prompts, args)  # warm-up
        runs[name] = serve.serve_llm_traffic(dict(llm, plans=which), prompts, args)

    def demotions():
        return sum(p.guard_stats()["counters"]["fallbacks"] for p in plans["guarded"].values())

    check(demotions() == 0, f"{label} guarded at 0%: {demotions()} demotions")
    tokens = {k: [[int(t) for t in h.result()] for h in r["handles"]] for k, r in runs.items()}
    if exact:
        with FaultPlan([FaultRule("*", "raise", rate=1.0)], seed=7):
            runs["guarded@100%"] = serve.serve_llm_traffic(dict(llm, plans=plans["guarded"]),
                                                           prompts, args)
        at100 = [[int(t) for t in h.result()] for h in runs["guarded@100%"]["handles"]]
        check(tokens["guarded"] == tokens["kernel"], f"{label} guarded at 0%: tokens {tokens}")
        check(demotions() > 0 and at100 == tokens["reference"],
              f"{label} guarded at 100%: {demotions()} demotions, tokens {at100}")
        how = (f"the kernel plans' greedy tokens at 0% faults (0 demotions), the reference "
               f"plans' at 100% ({demotions()} demotions)")
    else:
        for p, got in zip(prompts, tokens["guarded"]):
            serve.greedy_parity(llm, p, got)
        how = "0 demotions, greedy parity ok against the plain forward"
    for k, r in runs.items():
        check(r["stats"]["failed"] == 0 and r["occupancy"]["used_pages"] == 0,
              f"{label} {k}: stats {r['stats']} pages {r['occupancy']}")
    ms = " ".join(
        f"{k} {r['stats']['decode_seconds'] / r['stats']['decode_batches'] * 1e3:.2f}"
        f"/{r['stats']['prefill_seconds'] / r['stats']['prefill_batches'] * 1e3:.2f}"
        for k, r in runs.items())
    print(f"  {label} guarded ({len(plans['guarded']['decode'].steps)} steps a plan call): "
          f"{how}; failed=0 leaked=0; ms per decode step / prefill: {ms}")


def plan_param_bytes(*plans) -> int:
    """The param bytes of ``plans`` as ``memory_estimate`` counts them (every
    leaf of ``plan.graph.params``), a tensor the plans share counted once:
    what the card holds for them."""
    leaves = {}
    for plan in plans:
        for p in plan.graph.params.values():
            for t in p.values():
                leaves[(t.data_ptr(), t.numel(), t.dtype)] = t.numel() * t.element_size()
    return sum(leaves.values())


def block_pruned_llm(torch, llm, block, masks=None):
    """The compiler's block-pruning path on built params: ``project`` every
    ``q_i`` / ``o_i`` weight onto ``block`` -- or, with ``masks`` (``{q_i /
    o_i: mask}``, e.g. a trained model's ``hard_prune`` masks on params
    that ``apply_masks`` already masked), take those masks as they are --
    ``optimize`` the decoder graphs with the masks (``substitute_sparse``
    packs them as PBCSR nodes) and compile both phases for the kernel
    backend.  The returned llm's ``params`` are the masked-dense tree, which
    the plain ``forward`` of the parity check runs; its masked q / o weights
    wait in host memory (``params_on_host``) until the parity check, so
    that the serving run's peak is the pruned plans' own."""
    from repro_torch.core.graph import compile_plan
    from repro_torch.core.graph.passes import optimize
    from repro_torch.core.pruning import project
    from repro_torch.models.transformer_graph import build_decoder_graph

    cfg, params, dev = llm["cfg"], llm["params"], llm["device"]
    given, masks, structures, layers = masks, {}, {}, []
    for i, lp in enumerate(params["layers"]):
        attn = dict(lp["attn"])
        for key, node in (("w_q", f"q_{i}"), ("w_o", f"o_{i}")):
            if given is None:
                w, masks[node] = project(attn[key]["w"], block)
            else:
                w, masks[node] = attn[key]["w"], given[node]
            structures[node] = block
            attn[key] = {**attn[key], "w": w.cpu()}
        layers.append({**lp, "attn": attn})
    graphs = {ph: optimize(build_decoder_graph(params, cfg, phase=ph), masks, structures)
              for ph in ("prefill", "decode")}
    # each phase's optimize packs its own copy of every pruned weight: the
    # prefill graph takes the decode graph's (the same bits), so the card
    # holds one copy, as the dense plans share one set of weights
    dec = graphs["decode"].params
    for n in graphs["prefill"].nodes:
        if n.op == "sparse_linear" and n.attrs["format"] == "pbcsr":
            mine, theirs = graphs["prefill"].params[n.name], dec[n.name]
            check(mine.keys() == theirs.keys() and all(
                torch.equal(mine[k], theirs[k]) for k in mine),
                f"pruned llm: {n.name} packs differently in the two phases")
            graphs["prefill"].params[n.name] = theirs
    plans = {ph: compile_plan(g, backend="kernel", device=dev) for ph, g in graphs.items()}
    return dict(cfg=cfg, params={**params, "layers": layers}, graphs=graphs, plans=plans,
                device=dev, params_on_host=True)


def serve_llm_checked(torch, llm, args, smoke, label, per_call, n_glue=0):
    """One warm-up run, one timed run with the launch counts set to 0 just
    before it and read just after (checked per plan call: ``per_call`` plus
    one flash_attention and one ffn_gateup per layer, nothing else), one
    profiled run; then finite prefill logits near the reference plan's and
    the plain ``forward``'s, and greedy parity of every served sequence
    against ``forward`` -- exact in f32, the bf16 near-tie rule of
    ``serve.PARITY_BF16_ULPS`` at full width.  Returns the launches and
    the timed run's peak allocated bytes (beside ``memory_estimate``'s
    figure for the prefill plan at the served prompts)."""
    from repro_torch.core.graph import compile_plan
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models.transformer import forward

    cfg, plans, dev = llm["cfg"], llm["plans"], llm["device"]
    n_layers = cfg.n_layers
    steps = {ph: len(p.steps) for ph, p in plans.items()}
    want_steps = 9 * n_layers + 2 + 2 * n_glue
    check(steps == {"prefill": want_steps, "decode": want_steps},
          f"{label}: plan steps {steps}, want {want_steps} each")
    per_call = {**per_call, "flash_attention": n_layers, "ffn_gateup": n_layers}
    prompts = serve.llm_prompts(args, cfg)

    serve.serve_llm_traffic(llm, prompts, args)  # warm-up
    ops.reset_kernel_launches()
    torch.cuda.reset_peak_memory_stats()
    run = serve.serve_llm_traffic(llm, prompts, args)
    launches = main_path_launches(ops)
    peak = torch.cuda.max_memory_allocated()
    st, occ = run["stats"], run["occupancy"]
    calls = st["prefill_batches"] + st["decode_batches"]
    for name, got in launches.items():
        n = per_call.get(name, 0) * calls
        check(got == n, f"{label}: {name} launched {got} times over {calls} plan calls, "
                        f"want {per_call.get(name, 0)} per call")
    check(st["failed"] == 0 and st["completed"] == len(prompts), f"{label}: stats {st}")
    check(occ["used_pages"] == 0, f"{label}: {occ['used_pages']} KV pages leaked")
    toks = sum(len(h.result()) for h in run["handles"])
    check(toks == len(prompts) * args.new_tokens, f"{label}: {toks} tokens served")
    ms_decode = st["decode_seconds"] / st["decode_batches"] * 1e3
    ms_prefill = st["prefill_seconds"] / st["prefill_batches"] * 1e3
    launch_txt = " ".join(f"{k}={v}" for k, v in per_call.items())
    s_max = max(len(p) for p in prompts)
    est = plans["prefill"].memory_estimate(
        torch.zeros(len(prompts), s_max, dtype=torch.int32),
        torch.zeros(len(prompts), s_max, dtype=torch.int32),
        torch.zeros(len(prompts), dtype=torch.int32))
    print(f"  {label}: plan steps prefill={steps['prefill']} decode={steps['decode']}; served "
          f"{len(prompts)} sequences, {toks} tokens in {run['seconds']:.3f}s "
          f"({toks / run['seconds']:.1f} tok/s): {st['prefill_batches']} prefill + "
          f"{st['decode_batches']} decode plan calls, {ms_prefill:.2f} ms/prefill "
          f"{ms_decode:.2f} ms/decode step; per-call launches {launch_txt}; "
          f"failed={st['failed']}; KV pages {occ['num_pages']}x{occ['page_size']} "
          f"peak={occ['peak_used']} leaked={occ['used_pages']}; peak_alloc={peak / 1e9:.3f}GB "
          f"(memory_estimate, prefill of {len(prompts)}x{s_max}: params "
          f"{est['param_bytes'] / 1e9:.3f}GB + activations "
          f"{est['peak_activation_bytes'] / 1e9:.3f}GB = {est['peak_total_bytes'] / 1e9:.3f}GB)")
    # the params the card holds, a tensor counted once: memory_estimate
    # counts every leaf, so a tied embedding (granite: the embed table and
    # the unembed's transposed view of it) twice
    resident = plan_param_bytes(plans["prefill"])
    check(peak >= resident, f"{label}: peak {peak} B below the params' {resident} B")
    flash_per_call(torch, llm, prompts, args, label, n_layers)
    if llm.pop("params_on_host", False):  # the parity tree back on the card
        llm["params"] = _to_device(llm["params"], dev)

    # correctness: finite prefill logits of the right shape, near the
    # reference backend's and the plain forward's; greedy parity per sequence
    p0 = prompts[0]
    n0 = len(p0)
    inputs = (p0[None], np.arange(n0, dtype=np.int32)[None], np.array([n0], np.int32))
    with torch.no_grad():
        logits = plans["prefill"](plans["prefill"].graph.params, *inputs)[0].float()
        ref_plan = compile_plan(plans["prefill"].graph, backend="reference", device=dev)
        ref = ref_plan(ref_plan.graph.params, *inputs)[0].float()
        fwd = forward(llm["params"], cfg, torch.from_numpy(p0[None]).to(dev))[0].float()
    check(tuple(logits.shape) == (1, n0, cfg.vocab_padded),
          f"{label}: logits {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), f"{label}: non-finite logits")
    v = cfg.vocab
    err_ref = (logits[..., :v] - ref[..., :v]).abs().max().item()
    err_fwd = (logits[..., :v] - fwd[..., :v]).abs().max().item()
    top = fwd[..., :v].abs().max().item()
    if smoke:  # f32: the kernels' sums differ from torch's in order only
        check(err_fwd <= 1e-4 * max(1.0, top), f"{label}: prefill vs forward {err_fwd}")
    parity = [serve.greedy_parity(llm, p, [int(t) for t in h.result()])
              for p, h in zip(prompts, run["handles"])]
    if smoke:
        check(all(par["exact"] for par in parity), f"{label}: greedy parity {parity}")
    compared = sum(par["compared"] for par in parity)
    ties = [par["near_tie"] for par in parity if par["near_tie"] is not None]
    tie_txt = "; ".join(f"margin {m:.4f} < {t:.4f}" for m, t in ties) or "none"
    print(f"  prefill logits vs reference plan {err_ref:.3e}, vs plain forward {err_fwd:.3e} "
          f"(max|logit| {top:.3f}); greedy parity ok: {compared}/{toks} tokens compared and "
          f"equal to the teacher-forced plain forward's argmax "
          f"(exact={all(par['exact'] for par in parity)}; "
          f"near-ties: {tie_txt}; smallest top-2 margin "
          f"{min(par['min_margin'] for par in parity):.4f}); teacher-forced: every served "
          f"token within {max(par['max_forced_gap'] for par in parity):.4f} of forward's best "
          f"logit (tolerance {'0 (f32)' if smoke else f'{serve.PARITY_BF16_ULPS} bf16 ulps'})")
    del ref_plan
    return launches, peak


def flash_per_call(torch, llm, prompts, args, label, n_layers):
    """One profiled serving run (the profile line), then flash attention's
    device ms a prefill and a decode plan call in it, beside the GEMM
    kernels' (dense, gate/up, block-sparse) ms a plan call of either phase:
    decode calls run the split route (one query row), prefill calls one
    other route; the launches of each route in the run are checked against
    that before the time of each route is divided by its calls."""
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.launch import serve

    last = {}

    def serve_once():
        last["run"] = serve.serve_llm_traffic(llm, prompts, args)

    routes0 = dict(kflash.route_launches)
    prof = profile_serving(torch, f"llm {label}", serve_once, top_n=8)
    st = last["run"]["stats"]
    runs = sum(kflash.route_launches.values()) - sum(routes0.values())
    calls = st["prefill_batches"] + st["decode_batches"]
    routes = {r: n - routes0[r] for r, n in kflash.route_launches.items()}
    by = {k.split("/", 1)[1]: v / 1e3 for k, v in prof["by"].items()
          if k.startswith("flash_attention/")}
    gemm = sum(v for k, v in prof["by"].items()
               if k in ("dense_matmul", "ffn_gateup", "bsr_matmul")) / 1e3
    prefill = [r for r, n in routes.items() if n and r != "split"]
    if (runs != n_layers * calls or len(prefill) != 1
            or routes["split"] != n_layers * st["decode_batches"]):
        print(f"  flash_attention in the profiled run: routes {routes} over "
              f"{st['prefill_batches']} prefill + {st['decode_batches']} decode plan calls "
              f"(not one route a phase); device ms by route "
              + " ".join(f"{r}={ms:.3f}" for r, ms in by.items()))
        return
    pre, dec = st["prefill_batches"], st["decode_batches"]
    print(f"  flash_attention device ms a plan call (profiled run, {pre} prefill + {dec} decode "
          f"plan calls): prefill {by.get(prefill[0], 0.0) / pre:.3f} ms ({prefill[0]}, "
          f"{n_layers} launches), decode {by.get('split', 0.0) / dec:.3f} ms (split, "
          f"{n_layers} launches); the GEMM kernels (dense_matmul, ffn_gateup, bsr_matmul) "
          f"{gemm / calls:.3f} ms a plan call of either phase")


#: the device / profiler ratio every non-guarded profile must keep: summed
#: step device ms (CUDA events between steps) over the time torch.profiler
#: sees the card spend on the same plan call -- its kernels and the idle
#: between consecutive kernels inside each sleep-bounded window
PROFILE_RATIO = (0.8, 1.2)
#: the longest the card may sit idle between two consecutive kernels of a
#: timed window.  ``profile_plan``'s window check already rules out a wait
#: on the host; this catches one it would miss, which would show as a gap
#: of a step's host time (tens to hundreds of us)
PROFILE_MAX_GAP_US = 50.0


def _top(steps, key, n=5) -> str:
    rows = sorted(steps, key=lambda st: -getattr(st, key))[:n]
    return ", ".join(f"{st.name}({st.op})={getattr(st, key):.4f}" for st in rows)


def profile_checked(torch, label, plan, params, *inputs):
    """``profile_plan`` on ``plan`` (3 traced runs after a warm-up): rows
    equal to the plan's steps, host and device ms per plan call, the top 5
    steps by each; then one more profiled call under torch.profiler.  Its
    kernels after the call's first sleep (``spin_kernel``), window by
    window, give the card's kernel time (busy), the idle between
    consecutive kernels and the longest such gap: the summed step device ms
    is held to busy + idle (``PROFILE_RATIO``), the longest gap to
    ``PROFILE_MAX_GAP_US`` (no wait on the host inside a window), and the
    ratio to busy alone is printed with the kernel count.  A guarded plan
    must report no device ms (its per-step host sync).  Returns the profile
    and the ratio (None for a guarded plan)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import profile_plan

    pp = profile_plan(plan, params, *inputs, runs=3, warmup=1)
    check([st.name for st in pp.steps] == [st.node.name for st in plan.steps],
          f"profile {label}: {len(pp.steps)} rows for {len(plan.steps)} steps")
    if plan.backend == "guarded":
        check(pp.total_device_ms is None and all(st.device_ms is None for st in pp.steps)
              and pp.device_note, f"profile {label}: a guarded plan reported device ms")
        print(f"    profile {label}: {len(pp.steps)} rows = steps; host {pp.total_ms:.3f} ms a "
              f"plan call; device n/a ({pp.device_note}); top host: {_top(pp.steps, 'ms')}")
        return pp, None
    check(pp.total_device_ms is not None and pp.total_device_ms > 0,
          f"profile {label}: no device time")
    cuda = torch.autograd.DeviceType.CUDA
    busy = idle = max_gap = 0.0
    n_kernels = 0
    for _ in range(PROFILE_ATTEMPTS):  # a session may see no device events
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            one = profile_plan(plan, params, *inputs, runs=1, warmup=1)
        kernels = sorted((e.time_range.start, e.time_range.end, "spin_kernel" in e.name)
                         for e in prof.events() if e.device_type == cuda)
        spins = [i for i, k in enumerate(kernels) if k[2]]
        if len(spins) < one.device_windows:
            continue
        # the timed call's windows: the kernels between one sleep and the next
        bounds = spins[len(spins) - one.device_windows:] + [len(kernels)]
        busy = idle = max_gap = 0.0
        n_kernels = 0
        for lo, hi in zip(bounds, bounds[1:]):
            window = kernels[lo + 1:hi]
            n_kernels += len(window)
            busy += sum(end - start for start, end, _ in window)
            gaps = [max(0.0, b[0] - a[1]) for a, b in zip(window, window[1:])]
            idle += sum(gaps)
            max_gap = max([max_gap] + gaps)
        if busy > 0:
            break
    check(busy > 0, f"profile {label}: the profiler saw no device time")
    seen_ms = (busy + idle) / 1e3
    ratio = one.total_device_ms / seen_ms
    print(f"    profile {label}: {len(pp.steps)} rows = steps; per plan call host "
          f"{pp.total_ms:.3f} ms, device {pp.total_device_ms:.3f} ms (median of 3 runs, "
          f"{pp.device_windows} window(s)); profiled call: step device ms "
          f"{one.total_device_ms:.3f} / profiler {seen_ms:.3f} ms (busy {busy / 1e3:.3f} + idle "
          f"between kernels {idle / 1e3:.3f}, {n_kernels} kernels, longest gap "
          f"{max_gap:.1f} us) = {ratio:.3f}; / busy alone = "
          f"{one.total_device_ms / (busy / 1e3):.3f}")
    print(f"      top host: {_top(pp.steps, 'ms')}")
    print(f"      top device: {_top(pp.steps, 'device_ms')}")
    check(PROFILE_RATIO[0] <= ratio <= PROFILE_RATIO[1],
          f"profile {label}: step device ms / profiler device time = {ratio} outside "
          f"{PROFILE_RATIO}")
    check(max_gap <= PROFILE_MAX_GAP_US,
          f"profile {label}: the card sat idle {max_gap} us between two kernels of a timed "
          f"window (waiting on the host?)")
    return pp, ratio


def phase_profile(torch, apps):
    """``profile_plan`` on each app's f32 and INT8 plan (batch 4, 256x256)
    and on one guarded plan; ``launch/profile`` on super resolution; then
    ``serve --async --metrics-dump`` through the CLI's ``main``: the
    snapshot file and its Chrome trace.  Returns the launches."""
    from repro_torch.core.graph import compile_plan
    from repro_torch.kernels import ops
    from repro_torch.launch import profile as profile_cli
    from repro_torch.launch import serve

    ops.reset_kernel_launches()
    for app, a in apps.items():
        x = a["frames"][:BATCH]
        profile_checked(torch, f"{app} f32", a["plan"], a["go"].params, x)
        profile_checked(torch, f"{app} int8", a["int8_plan"], a["gq"].params, x)
    guarded = compile_plan(apps["coloring"]["go"], backend="guarded", device="cuda")
    profile_checked(torch, "coloring f32 guarded", guarded, apps["coloring"]["go"].params,
                    apps["coloring"]["frames"][:BATCH])
    # the profile CLI on the card: the device columns filled
    out = ROOT / "build" / "chip_metrics" / "profile.json"
    prof = profile_cli.main(["--graph-app", "super_resolution", "--size", str(SIZE), "--base",
                             str(BASE), "--batch", str(BATCH), "--top", "5", "--json-out",
                             str(out)])
    doc = json.loads(out.read_text())
    check(doc["total_device_ms"] and all(st["device_ms"] is not None for st in doc["steps"])
          and len(doc["steps"]) == len(prof.steps) == EXPECTED["super_resolution"][0],
          f"profile CLI: {len(doc['steps'])} rows, device {doc['total_device_ms']}")
    launches = main_path_launches(ops)

    path = ROOT / "build" / "chip_metrics" / "metrics.json"
    for f in (path, Path(str(path) + ".trace.json")):
        f.unlink(missing_ok=True)
    serve.main(["--async", "--graph-app", "coloring", "--size", str(SIZE), "--base", str(BASE),
                "--frames", "16", "--metrics-dump", str(path), "--metrics-interval", "0.05"])
    snap = json.loads(path.read_text())
    doc = json.loads(Path(str(path) + ".trace.json").read_text())
    last = snap["snapshots"][-1]["metrics"]
    done = sum(x["value"] for x in last["serving_events_total"]["samples"]
               if x["labels"].get("event") == "completed")
    batches = [e for e in doc["traceEvents"] if e.get("name") == "batch" and e["ph"] == "B"]
    requests = [e for e in doc["traceEvents"] if e.get("name") == "request" and e["ph"] == "e"]
    check(len(snap["snapshots"]) >= 1 and done >= 16 and batches and len(requests) >= 16,
          f"metrics dump: {len(snap['snapshots'])} snapshots, {done} completed, "
          f"{len(batches)} batch spans, {len(requests)} ended requests")
    print(f"    metrics dump: {len(snap['snapshots'])} snapshots ({done:.0f} completed requests "
          f"in the last), trace {len(doc['traceEvents'])} events ({len(batches)} batch spans, "
          f"{len(requests)} requests ended) -> {path.relative_to(ROOT)}(.trace.json)")
    return launches


def profile_llm(torch, llm, args):
    """``profile_checked`` on one prefill plan call (the served prompts,
    padded) and one decode plan call (a 2-page span) of the decoder."""
    from repro_torch.launch import serve

    cfg, plans, dev = llm["cfg"], llm["plans"], llm["device"]
    prompts = serve.llm_prompts(args, cfg)
    b, s = len(prompts), max(len(p) for p in prompts)
    tokens = torch.zeros(b, s, dtype=torch.int32)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = torch.from_numpy(p)
    lengths = torch.tensor([len(p) for p in prompts], dtype=torch.int32)
    positions = torch.arange(s, dtype=torch.int32).expand(b, s).contiguous()
    print(f"  profile ({cfg.name}, prefill {b}x{s}, decode {b} rows over a "
          f"{2 * args.kv_page_size}-slot span)")
    with torch.no_grad():
        profile_checked(torch, f"{cfg.name} prefill", plans["prefill"],
                        plans["prefill"].graph.params, tokens, positions, lengths)
        gen = torch.Generator(device=dev).manual_seed(SEED + 21)
        span = 2 * args.kv_page_size
        shape = (b, cfg.n_layers, span, cfg.n_kv_heads, cfg.resolved_head_dim)
        k_ctx = torch.randn(shape, generator=gen, device=dev) * 0.5
        v_ctx = torch.randn(shape, generator=gen, device=dev) * 0.5
        profile_checked(torch, f"{cfg.name} decode", plans["decode"],
                        plans["decode"].graph.params, tokens[:, :1], lengths[:, None],
                        k_ctx, v_ctx, lengths)
        del k_ctx, v_ctx


def phase_serve_forward(torch):
    """The CLI's default path (``get_model`` + ``Engine`` + ``--scheduler``)
    at its defaults on phi4-mini-3.8b at full width: every returned row
    passes the greedy-parity probe inside ``serve_forward``."""
    from repro_torch.launch import serve

    t0 = time.perf_counter()
    report = serve.main(["--arch", "phi4-mini-3.8b", "--scheduler", "--device", "cuda"])
    toks = report["tokens"]
    check(toks.shape == (4, 12) and all(r.done for r in report["scheduler"]),
          f"serve forward: tokens {toks.shape}, scheduler {report['scheduler']}")
    print(f"  serve forward: {report['tok_per_s']:.1f} tok/s in Engine.generate, "
          f"{len(report['scheduler'])} scheduler requests returned done, "
          f"{time.perf_counter() - t0:.1f}s in all (init included); "
          f"peak_alloc={torch.cuda.max_memory_allocated() / 1e9:.3f}GB")
    torch.cuda.empty_cache()


#: the zoo: every smoke config card against CPU (f32), then the families the
#: earlier phases do not serve, at full width in bf16 (deepseek-v2-236b's
#: 471.6 GB of bf16 weights fit no card: it runs at smoke only)
ZOO_FULL = ("qwen3-14b", "deepseek-v2-lite-16b", "recurrentgemma-9b", "paligemma-3b",
            "mamba2-1.3b", "whisper-small")
#: card against CPU on the smoke configs: within this x max(1, max|cpu|)
ZOO_RTOL = 1e-3


@contextlib.contextmanager
def zoo_launch_check(ops):
    """The zoo runs plain torch, as the JAX package's zoo runs plain jnp (no
    ``pl.pallas_call`` on its paths): no kernel of the port may launch in
    it."""
    before = dict(ops.kernel_launch_counts())
    yield
    after = dict(ops.kernel_launch_counts())
    check(after == before, f"zoo: kernels launched {after} (before {before})")
    print("  zoo: no kernel of the port launched (plain torch, as in the JAX package)")


def _zoo_err(torch, got, want) -> float:
    """max |card - cpu| over max(1, max |cpu|), pad classes (-1e30) out."""
    want = want.float()
    got = got.detach().float().cpu()
    keep = want > -1e29
    return float((got - want).abs()[keep].max()) / max(1.0, float(want.abs()[keep].max()))


def phase_zoo_smoke(torch):
    """All ten smoke configs (f32) on the card against the same params on the
    CPU: prefill logits, 4 decode steps' logits and ``loss`` within
    ZOO_RTOL x max(1, max|cpu|), and ``Engine`` greedy tokens equal (a VLM
    with its patch embeddings); whisper: ``decode_train`` logits, 4
    ``decode_step``s from ``precompute_cross_kv`` and ``loss``."""
    from repro_torch.configs import ARCH_IDS, smoke_config
    from repro_torch.models import encdec, get_model
    from repro_torch.models import transformer as lm
    from repro_torch.serving import Engine

    dev = torch.device("cuda")
    for arch in ARCH_IDS:
        cfg = smoke_config(arch)
        rng = np.random.default_rng(SEED)
        tok = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32))
        frames = torch.from_numpy(rng.standard_normal(
            (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)) if cfg.is_encdec else None
        pe = torch.from_numpy(rng.standard_normal(
            (2, cfg.vision_tokens, cfg.d_model)).astype(np.float32)) if cfg.vision_tokens else None
        params = get_model(cfg, device="cpu").init(torch.Generator().manual_seed(SEED))
        out = {}
        for d in ("cpu", "cuda"):
            model = get_model(cfg, device=d)
            p = params if d == "cpu" else _to_device(params, dev)
            t = tok.to(d)
            r = {}
            with torch.no_grad():
                if cfg.is_encdec:
                    enc = encdec.encode(p, cfg, frames.to(d))
                    r["prefill"] = encdec.decode_train(p, cfg, t[:, :8], enc)
                    state = (model.init_cache(2, 32), encdec.precompute_cross_kv(p, cfg, enc))
                    batch = {"frames": frames.to(d), "tokens": t[:, :-1], "labels": t[:, 1:]}
                    steps = t[:, :4]
                else:
                    logits, state = lm.prefill(p, cfg, t[:, :8], 32,
                                               patch_embeds=None if pe is None else pe.to(d))
                    r["prefill"] = logits
                    batch = {"tokens": t[:, :-1], "labels": t[:, 1:]}
                    if pe is not None:
                        batch["patch_embeds"] = pe.to(d)
                    steps = t[:, 8:12]
                    r["engine"] = Engine(model, p, batch_size=2, max_len=48).generate(
                        t[:, :8], 6, patch_embeds=batch.get("patch_embeds")).tokens
                for i in range(4):
                    logits, state = model.decode_step(p, {"tokens_t": steps[:, i:i + 1]}, state)
                    r[f"step{i}"] = logits
                r["loss"] = model.loss(p, batch)[0]
            out[d] = r
        errs = {k: _zoo_err(torch, out["cuda"][k], out["cpu"][k]) for k in out["cpu"]
                if k != "engine"}
        worst = max(errs, key=errs.get)
        check(errs[worst] <= ZOO_RTOL, f"zoo smoke {arch}: {worst} off by {errs[worst]:.3g} "
                                       f"x max(1, max|cpu|)")
        if "engine" in out["cpu"]:
            check(np.array_equal(out["cuda"]["engine"], out["cpu"]["engine"]),
                  f"zoo smoke {arch}: Engine tokens {out['cuda']['engine'].tolist()} on the "
                  f"card, {out['cpu']['engine'].tolist()} on the CPU")
        print(f"  {arch} (smoke, f32): prefill {errs['prefill']:.2e}, decode steps "
              f"{max(errs[f'step{i}'] for i in range(4)):.2e}, loss {errs['loss']:.2e} "
              f"x max(1, max|cpu|)"
              + ("; Engine tokens equal" if "engine" in out["cpu"] else "; decode_step logits"))
        del params, out
    torch.cuda.empty_cache()


def _zoo_families(torch, prof):
    """Device us by kernel family of one profiled run (torch.profiler), and
    the number of kernels it ran."""
    by, n = {}, 0
    for e in prof.key_averages():
        us = e.self_device_time_total
        if e.device_type != torch.autograd.DeviceType.CUDA or us <= 0:
            continue
        n += e.count
        key = e.key.lower()
        fam = next((f for frags, f in (
            (("gemm", "xmma", "cutlass", "cublas", "nvjet"), "gemm"), (("softmax",), "softmax"),
            (("reduce",), "reduce"), (("sort", "radix"), "sort"), (("scan",), "scan"),
            (("index", "gather", "scatter"), "index"), (("catarray",), "cat"),
            (("memcpy", "copy"), "copy"), (("elementwise", "vectorized"), "elementwise"))
            if any(x in key for x in frags)), "other")
        if fam == "other":
            fam = "other:" + e.key.split("(")[0].split("<")[0][-40:]
        by[fam] = by.get(fam, 0.0) + us
    return by, n


def _zoo_profile(torch, label, fn):
    """One run of ``fn`` under torch.profiler: device busy ms, wall ms, idle
    share and the top kernel families."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_ATTEMPTS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        by, n_kernels = _zoo_families(torch, prof)
        busy = sum(by.values()) / 1e3
        if busy > 0:
            break
    check(busy > 0, f"{label}: the profiler saw no device time")
    top = sorted(by.items(), key=lambda kv: -kv[1])[:5]
    print(f"    profile {label}: device {busy:.2f} ms of wall {wall:.2f} ms (idle "
          f"{1 - busy / wall:.0%}), {n_kernels} kernels; "
          + " ".join(f"{k} {v / 1e3:.2f} ({v / 1e3 / busy:.0%})" for k, v in top))
    return dict(busy=busy, wall=wall, idle=1 - busy / wall, top=top, kernels=n_kernels)


def _synced(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    return r, (time.perf_counter() - t0) * 1e3


def phase_zoo_full(torch, arch, smi):
    """``arch`` at full width in bf16 through ``get_model`` and the ``Engine``
    (whisper: ``encode`` + ``precompute_cross_kv`` + ``decode_step``), from
    a CUDA generator seeded with SEED: the JAX CLI's traffic (3 prompts of
    16 tokens padded to batch 4, 12 new tokens; a VLM with 256 patch
    embeddings a row) timed with CUDA-synchronised walls, finite logits,
    ``generate`` equal to the timed loop, greedy parity of the 3 rows
    against the teacher-forced ``forward`` (mamba2's on f32 weights; none for
    a MoE model), and a 2x oversubscribed ``RequestScheduler`` with no failed
    request; mamba2 also holds its chunked prefill to the step recurrence
    (in f32); then a profiled run.  Returns the numbers it prints."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import get_model
    from repro_torch.serving import Engine, Request, RequestScheduler
    from repro_torch.utils.tree import leaves

    dev = torch.device("cuda")
    cfg = get_config(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = get_model(cfg, device=dev)
    params, init_ms = _synced(torch, lambda: model.init(torch.Generator(device=dev).manual_seed(
        SEED)))
    gb = nbytes(*leaves(params)) / 1e9
    init_peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    print(f"  {arch}: {gb:.3f} GB of bf16 params drawn on the card in {init_ms:.0f} ms "
          f"(peak {init_peak:.3f} GB: one f32 draw of the largest weight on top; {smi})")
    if cfg.is_encdec:
        rep = _zoo_encdec(torch, cfg, model, params)
    else:
        rep = _zoo_decoder(torch, cfg, model, params, serve, Engine, Request, RequestScheduler)
    rep.update(arch=arch, params_gb=gb, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               init_peak_gb=init_peak)
    print(f"  {arch}: {rep['tok_s']:.1f} tok/s, {rep['ms_prefill']:.2f} ms/prefill, "
          f"{rep['ms_decode']:.2f} ms/decode step (median of {rep['n_steps']}), "
          f"peak_alloc={rep['serve_peak_gb']:.3f}GB serving, {rep['peak_gb']:.3f}GB with the "
          f"checks")
    del params, model
    torch.cuda.empty_cache()
    return rep


def _zoo_decoder(torch, cfg, model, params, serve, Engine, Request, RequestScheduler):
    from repro_torch.models import get_model

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    n_real, n_new, plen = 3, 12, 16
    prompts = np.zeros((4, plen), np.int32)  # the 4th row pads the batch
    prompts[:n_real] = rng.integers(0, cfg.vocab, (n_real, plen))
    prompts = torch.from_numpy(prompts).to(dev)
    pe = None
    if cfg.vision_tokens:
        pe = torch.from_numpy(rng.standard_normal((4, cfg.vision_tokens, cfg.d_model)).astype(
            np.float32)).to(dev, torch.bfloat16)
    max_len = 128 + cfg.vision_tokens
    engine = Engine(model, params, batch_size=4, max_len=max_len)
    engine.generate(prompts, 2, patch_embeds=pe)  # warm-up: allocator, first launches

    (logits, caches), ms_prefill = _synced(torch, lambda: engine._prefill(params, prompts, pe))
    check(bool(torch.isfinite(logits[:, :cfg.vocab]).all()), f"{cfg.name}: prefill logits")
    tok = logits.argmax(-1).to(torch.int32)
    toks, dec = [tok], []
    for _ in range(n_new - 1):
        (logits, caches), ms = _synced(torch, lambda: engine._decode(params, tok[:, None], caches))
        check(bool(torch.isfinite(logits[:, :cfg.vocab]).all()), f"{cfg.name}: decode logits")
        tok = logits.argmax(-1).to(torch.int32)
        toks.append(tok)
        dec.append(ms)
    got = torch.stack(toks, 1).cpu().numpy()
    res = engine.generate(prompts, n_new, patch_embeds=pe)
    check(np.array_equal(res.tokens, got), f"{cfg.name}: generate {res.tokens.tolist()} vs the "
                                           f"timed loop {got.tolist()}")
    del caches
    serve_peak = torch.cuda.max_memory_allocated() / 1e9  # before the checks' own copies

    # a MoE model has no parity probe: forward over prompt + continuation
    # drops other token-slots than the prefill and the one-token steps (its
    # served tokens are held to the CPU in ``== zoo smoke`` and to the JAX
    # package by the CPU tests, in f32 and bf16).  Mamba-2's runs in f32
    # (the bf16 weights widened): its decode is the step recurrence and its
    # forward the chunked form, which round each layer's output to bf16 at
    # other values (a served logit fell 0.297 below forward's best at step 4
    # on an H100; the JAX package's two forms part as far in bf16, PERF.md),
    # while in f32 they agree to ~1e-6 (``_mamba_recurrence_check``)
    pars = []
    if cfg.moe is None:
        pcfg, pparams, how = cfg, params, ""
        if cfg.ssm is not None:
            pcfg, how = dataclasses.replace(cfg, dtype="float32"), " (f32 weights)"
            pparams = _to_device(params, torch.float32)
        ptoks = got if pcfg is cfg else Engine(
            get_model(pcfg, device=dev), pparams, batch_size=4, max_len=max_len).generate(
            prompts, n_new, patch_embeds=pe).tokens
        llm = dict(cfg=pcfg, params=pparams, device=dev)
        pars = [serve.greedy_parity(llm, prompts[i].cpu().numpy(), ptoks[i],
                                    patch_embeds=None if pe is None else pe[i:i + 1])
                for i in range(n_real)]
        del pparams
        print(f"    parity{how}: "
              + "; ".join(f"row {i}: {p['compared']}/{p['total']}"
                          + ("" if p["near_tie"] is None else " (near-tie)")
                          + f", forced gap {p['max_forced_gap']:.3f}"
                          for i, p in enumerate(pars)))
    else:
        print("    parity: none for MoE (forward over a longer sequence drops other "
              "token-slots); served tokens held card = CPU in == zoo smoke")

    if cfg.ssm is not None:
        _mamba_recurrence_check(torch, cfg, params, prompts[0, :plen])

    reqs = []
    for rid in range(8):  # 2x oversubscribed over 4 slots
        plen_r = int(rng.integers(4, plen))
        reqs.append(Request(rid=rid, prompt=rng.integers(0, cfg.vocab, plen_r).astype(np.int32),
                            max_new=int(rng.integers(3, n_new))))
    sched = RequestScheduler(engine)
    for r in reqs:
        sched.submit(r)
    _, ms_sched = _synced(torch, sched.run)
    failed = [r.rid for r in reqs if not r.done or len(r.generated) != r.max_new
              or not all(0 <= t < cfg.vocab for t in r.generated)]
    check(not failed, f"{cfg.name}: scheduler requests {failed} failed")
    print(f"    scheduler: {len(reqs)} requests over 4 slots in {ms_sched:.0f} ms, none failed")

    prof = _zoo_profile(torch, f"{cfg.name} generate", lambda: engine.generate(
        prompts, n_new, patch_embeds=pe))
    total = ms_prefill + sum(dec)
    return dict(tok_s=n_real * n_new / total * 1e3, ms_prefill=ms_prefill,
                ms_decode=statistics.median(dec), n_steps=len(dec), profile=prof,
                parity=pars, ms_scheduler=ms_sched, serve_peak_gb=serve_peak)


def _mamba_recurrence_check(torch, cfg, params, prompt):
    """The chunked SSD prefill against the step recurrence over the same
    prompt, in f32 (the bf16 weights widened): every position's logits and
    every layer's final state within ZOO_RTOL x max(1, max|prefill|)."""
    from repro_torch.models import transformer as lm

    p32 = _to_device(params, torch.float32)
    c32 = dataclasses.replace(cfg, dtype="float32")
    tok = prompt[None].to(torch.int32)
    with torch.no_grad():
        logits, caches = lm.prefill(p32, c32, tok, 64)
        state = lm.init_cache(c32, 1, 64, torch.float32, device=tok.device)
        steps = []
        for t in range(tok.shape[1]):
            lg, state = lm.decode_step(p32, c32, tok[:, t:t + 1], state)
            steps.append(lg)
    err = _zoo_err(torch, torch.cat(steps, 1), logits.cpu())
    serr = max(_zoo_err(torch, a["state"], b["state"].cpu()) for a, b in zip(state, caches))
    check(err <= ZOO_RTOL and serr <= ZOO_RTOL,
          f"{cfg.name}: step recurrence vs chunked prefill logits {err:.3g}, states {serr:.3g}")
    print(f"    chunked prefill vs step recurrence (f32, {tok.shape[1]} tokens, "
          f"{cfg.n_layers} layers): logits {err:.2e}, states {serr:.2e} x max(1, max|prefill|)")
    del p32


def _zoo_encdec(torch, cfg, model, params):
    """Whisper: ``encode`` 4 rows of 1500 stub frames, ``precompute_cross_kv``,
    then 12 greedy ``decode_step``s from token 0; the step tokens against
    ``decode_train`` over the same tokens by ``serve.parity_rule`` (bf16)."""
    from repro_torch.launch.serve import parity_rule
    from repro_torch.models import encdec

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    frames = torch.from_numpy(rng.standard_normal((4, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)).to(dev, torch.bfloat16)
    n_new = 12

    def run():
        with torch.no_grad():
            enc = encdec.encode(params, cfg, frames)
            cross = encdec.precompute_cross_kv(params, cfg, enc)
            state = (model.init_cache(4, 128), cross)
            tok = torch.zeros((4, 1), dtype=torch.int32, device=dev)
            seq, logits_all = [tok], []
            for _ in range(n_new):
                logits, state = model.decode_step(params, {"tokens_t": tok}, state)
                logits_all.append(logits[:, 0])
                tok = logits[:, 0].argmax(-1).to(torch.int32)[:, None]
                seq.append(tok)
            return enc, torch.cat(seq, 1), torch.stack(logits_all, 1)

    run()  # warm-up
    (enc, _), ms_encode = _synced(torch, lambda: (encdec.encode(params, cfg, frames), None))
    cross, ms_cross = _synced(torch, lambda: encdec.precompute_cross_kv(params, cfg, enc))
    state = (model.init_cache(4, 128), cross)
    tok = torch.zeros((4, 1), dtype=torch.int32, device=dev)
    dec = []
    for _ in range(n_new):
        (logits, state), ms = _synced(torch, lambda: model.decode_step(
            params, {"tokens_t": tok}, state))
        check(bool(torch.isfinite(logits[..., :cfg.vocab]).all()), f"{cfg.name}: decode logits")
        tok = logits[:, 0].argmax(-1).to(torch.int32)[:, None]
        dec.append(ms)
    serve_peak = torch.cuda.max_memory_allocated() / 1e9
    _, seq, step_logits = run()
    with torch.no_grad():
        forced = encdec.decode_train(params, cfg, seq[:, :-1], enc).float()
    v = cfg.vocab
    pars = [parity_rule(forced[row, :, :v], seq[row, 1:].tolist(), bf16=True)
            for row in range(4)]
    steps_ok = [p["compared"] for p in pars]
    gap_max = max(p["max_forced_gap"] for p in pars)
    diff = float((step_logits[..., :v].float() - forced[..., :v]).abs().max())
    print(f"    decode_step vs decode_train: tokens equal up to the first near-tie "
          f"({steps_ok} of {n_new} a row), every token within {gap_max:.4f} of decode_train's "
          f"best logit, max |logit diff| {diff:.4f}")
    prof = _zoo_profile(torch, f"{cfg.name} encode + 12 steps", run)
    total = ms_encode + ms_cross + sum(dec)
    return dict(tok_s=4 * n_new / total * 1e3, ms_prefill=ms_encode + ms_cross,
                ms_encode=ms_encode, ms_cross=ms_cross, ms_decode=statistics.median(dec),
                n_steps=len(dec), profile=prof, serve_peak_gb=serve_peak)


#: the training phases: the JAX launcher's defaults (batch 8 x seq 128, lr
#: 1e-3, --prune --sparsity 0.5) over 10 steps with a Z/U update every 2;
#: the hard prune follows step int(10 * 0.5) = 5, so 6 ADMM steps (3
#: updates) and 4 masked fine-tune steps
TRAIN_ARGS = ["--arch", "qwen2.5-3b", "--steps", "10", "--batch", "8", "--seq", "128",
              "--prune", "--sparsity", "0.5", "--admm-every", "2", "--hard-prune-at", "0.5",
              "--seed", str(SEED)]
#: the smoke run's losses, card against CPU: the same f32 ops summed in
#: another order, and at step 1 Adam's ``g / (|g| + eps)`` turns a gradient
#: element at rounding level into a full-size step of either sign, which
#: feeds every later step (the CPU tests hold the port to JAX the same way)
TRAIN_LOSS_RTOL = 1e-3


def _quiet(_):
    pass


def _masks_have_the_recipe(torch, masks, label):
    """Every Block(64, 64) mask constant on its tiles, every Column mask
    constant along each row; returns the number of masks."""
    from repro_torch.utils.tree import leaves_with_path

    n = 0
    for path, m in leaves_with_path(masks):
        n += 1
        if "['attn']" in path:
            k, c = m.shape
            tiles = m.reshape(k // 64, 64, c // 64, 64)
            check(bool((tiles == tiles[:, :1, :, :1]).all()), f"{label}: {path} not 64x64 tiles")
        else:
            check(bool((m == m[:, :1]).all()), f"{label}: {path} not whole rows")
    return n


def phase_train_smoke(torch):
    """The launcher's ADMM -> hard prune -> masked pipeline on the smoke
    qwen2.5-3b in f32, on the card and on the CPU from the same params (a
    CPU generator seeded with SEED): losses step by step within
    TRAIN_LOSS_RTOL, the same Z/U update steps, hard-prune masks
    ``torch.equal``.  Then checkpoint -> restore -> resume on the card
    through ``CheckpointManager``: the restored state ``torch.equal`` to the
    saved one, and three more steps from each."""
    import shutil

    from repro_torch.configs import smoke_config
    from repro_torch.core.pruning import AdmmConfig
    from repro_torch.data.pipeline import PipelineState, SyntheticPipeline
    from repro_torch.launch import train
    from repro_torch.models import get_model
    from repro_torch.training.checkpoint import CheckpointManager
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_loop import init_train_state, make_train_step
    from repro_torch.utils.tree import leaves_with_path, tree_map

    dev = torch.device("cuda")
    cfg = smoke_config("qwen2.5-3b")
    args = train.build_parser().parse_args(TRAIN_ARGS + ["--smoke", "--seq", "32"])
    model = get_model(cfg, device="cpu")
    params_cpu = model.init(torch.Generator().manual_seed(SEED))
    runs = {}
    for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        # a copy each: the launcher updates its params in place
        runs[name] = train.train(args, cfg, _to_device(tree_map(torch.clone, params_cpu), d), d,
                                 log=_quiet)
    hc, hp = runs["cuda"]["history"], runs["cpu"]["history"]
    rel = [abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(hc, hp)]
    check(len(hc) == len(hp) == args.steps and max(rel) <= TRAIN_LOSS_RTOL,
          f"train smoke: losses card vs CPU, relative differences {rel}")
    check([h["update"] for h in hc] == [h["update"] for h in hp]
          and runs["cuda"]["n_updates"] == runs["cpu"]["n_updates"] == 3,
          f"train smoke: Z/U updates {runs['cuda']['n_updates']} / {runs['cpu']['n_updates']}")
    mc = dict(leaves_with_path(runs["cuda"]["masks"]))
    mp = dict(leaves_with_path(runs["cpu"]["masks"]))
    check(mc.keys() == mp.keys() and all(torch.equal(mc[k].cpu(), mp[k]) for k in mp),
          "train smoke: hard-prune masks differ between the card and the CPU")
    n_masks = _masks_have_the_recipe(torch, runs["cuda"]["masks"], "train smoke")
    print(f"  train smoke: {args.steps} steps (6 ADMM, 3 Z/U updates, 4 masked), losses "
          f"{hc[0]['loss']:.4f} -> {hc[-1]['loss']:.4f} on the card; card vs CPU losses within "
          f"{max(rel):.2e} relative (tolerance {TRAIN_LOSS_RTOL}); {n_masks} hard-prune masks "
          f"torch.equal, pruned_global {runs['cuda']['sparsity']['pruned_global']:.4f}")
    del runs

    # checkpoint -> restore -> resume, on the card
    ckpt_dir = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    opt = AdamWConfig(lr=args.lr, total_steps=args.steps, warmup_steps=5)
    acfg = AdmmConfig(rho=1e-2, rho_ramp=1.2, rho_max=1.0, update_every=2)

    def fresh():
        p = _to_device(model.init(torch.Generator().manual_seed(SEED)), dev)
        return init_train_state(p, opt, admm_cfg=acfg, prune_plan=train.default_prune_plan(0.5))

    def batch(pipe):
        return {k: torch.from_numpy(v).to(dev) for k, v in pipe.next().items()}

    step = make_train_step(model.loss, opt, admm_cfg=acfg)
    pipe = SyntheticPipeline(cfg, batch=args.batch, seq=args.seq + 1, seed=args.seed)
    state = fresh()
    mgr = CheckpointManager(str(ckpt_dir), save_every=4, keep=2)
    for i in range(4):
        state, _ = step(state, batch(pipe))
        mgr.maybe_save(i + 1, (state, pipe.state.to_dict()))
    (restored, data), at = mgr.restore_latest((fresh(), {"data_step": 0}))
    saved, got = list(leaves_with_path(state)), list(leaves_with_path(restored))
    same = [p == q and (torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b)
            and (not isinstance(b, torch.Tensor) or b.device == a.device)
            for (p, a), (q, b) in zip(saved, got)]
    check(at == 4 and data == {"data_step": 4} and len(saved) == len(got) and all(same),
          f"train smoke: restored state differs from the saved one at step {at}")
    pipe_b = SyntheticPipeline(cfg, batch=args.batch, seq=args.seq + 1, seed=args.seed)
    pipe_b.state = PipelineState.from_dict(data)
    diffs = []
    for _ in range(3):
        state, ma = step(state, batch(pipe))
        restored, mb = step(restored, batch(pipe_b))
        diffs.append(abs(ma["loss"].item() - mb["loss"].item()) / abs(ma["loss"].item()))
    exact = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        leaves_with_path(state.params), leaves_with_path(restored.params)))
    check(max(diffs) <= 1e-5, f"train smoke: resumed losses differ by {diffs}")
    print(f"  checkpoint: {len(saved)} leaves saved at step 4 under build/train_ckpt, restored "
          f"torch.equal; 3 resumed steps against 3 uninterrupted ones: losses within "
          f"{max(diffs):.1e} relative (tolerance 1e-5), params torch.equal: {exact}")
    shutil.rmtree(ckpt_dir, ignore_errors=True)


def phase_train_full(torch, smi):
    """``launch.train``'s building blocks (``main``'s argument parsing and
    init, then ``train``) on qwen2.5-3b at full width in bf16 with
    TRAIN_ARGS: finite losses and grad norms, the Z/U updates where the JAX
    condition holds, rho on its f32 ramp, the primal residual positive (at
    most 1 until the second update, see ``PERF.md``), the hard prune's
    sparsity within 0.05 of 0.5, the recipe's mask structure, and after the
    fine-tune ``apply_masks`` zero exactly where the (unchanged) masks are.
    Prints ms per ADMM / masked step and per Z/U update, tokens/s,
    model-FLOPs utilization and peak allocated per phase.  Then the
    hand-off: the optimizer and ADMM state go, ``apply_masks(params,
    masks)`` with the ``w_q`` / ``w_o`` masks keyed ``q_i`` / ``o_i`` goes
    through :func:`block_pruned_llm` as given and serves the JAX CLI's
    traffic through :func:`serve_llm_checked`.  Returns its launches."""
    import argparse

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.pruning import Block, apply_masks, count_params, tree_sparsity_report
    from repro_torch.launch import train
    from repro_torch.models import get_model
    from repro_torch.utils.flops import model_flops
    from repro_torch.utils.tree import leaves_with_path

    dev = torch.device("cuda")
    args = train.build_parser().parse_args(TRAIN_ARGS + ["--device", "cuda"])
    cfg = get_config(args.arch)
    t0 = time.perf_counter()
    at_prune = {}

    def keep_masks(_, masks):  # a copy of the masks as the hard prune made them
        at_prune.update((p, m.bool()) for p, m in leaves_with_path(masks))

    # no reference to the initial params here: the hard prune frees the raw
    # pruned weights, as in ``main``
    rep = train.train(
        args, cfg, get_model(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(
            args.seed)), dev, log=print, on_hard_prune=keep_masks)
    wall = time.perf_counter() - t0
    hist, peaks = rep["history"], rep["peak_bytes"]
    check(all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in hist),
          "train: non-finite loss or grad norm")
    want = [(h["step"] + 1) % args.admm_every == 0 and h["phase"] == "admm" for h in hist]
    check([h["update"] for h in hist] == want and rep["n_updates"] == sum(want) == 3,
          f"train: Z/U updates {[h['update'] for h in hist]}, n_updates {rep['n_updates']}")
    rho, ok = np.float32(1e-2), True
    for h in hist:
        if h["phase"] != "admm":
            continue
        if h["update"]:
            rho = min(rho * np.float32(1.2), np.float32(1.0))
        ok = ok and h["rho"] == float(rho)
        res = h["primal_residual"]
        # ||W - Z|| / ||W|| <= 1 while Z = Pi(W): until the second update
        # (Z = Pi(W + U) after it can keep pruned units, doubled)
        ok = ok and np.isfinite(res) and res > 0 and (
            res <= 1 or h["step"] >= 2 * args.admm_every - 1)
    check(ok, f"train: rho / residual {[(h.get('rho'), h.get('primal_residual')) for h in hist]}")
    sp = rep["sparsity"]["pruned_global"]
    check(abs(sp - 0.5) <= 0.05, f"train: pruned_global {sp}")
    state, masks = rep.pop("state"), rep.pop("masks")
    params = state.params
    del state  # the optimizer moments go; the ADMM state went at the hard prune
    n_params = count_params(params)
    n_masks = _masks_have_the_recipe(torch, masks, "train")
    mflat = dict(leaves_with_path(masks))
    check(n_masks == 4 * cfg.n_layers and mflat.keys() == at_prune.keys() and all(
        torch.equal(mflat[p].bool(), at_prune[p]) for p in mflat),
          "train: masks changed during the fine-tune")
    del at_prune
    check(tree_sparsity_report(params, masks)["pruned_global"] == sp,
          "train: the report moved during the fine-tune")
    masked = apply_masks(params, masks)
    for path, w in leaves_with_path(masked):
        m = mflat.get(path)
        if m is not None:
            check(bool((w[m == 0] == 0).all()), f"train: {path} nonzero where masked")
    drift = max(float(w[mflat[p] == 0].abs().max()) for p, w in leaves_with_path(params)
                if p in mflat)

    admm = [h["ms"] for h in hist if h["phase"] == "admm"]
    upd = [h["ms"] for h in hist if h["phase"] == "admm" and h["update"]]
    plain = [h["ms"] for h in hist[1:] if h["phase"] == "admm" and not h["update"]]
    fine = [h["ms"] for h in hist if h["phase"] == "masked"]
    ms_admm, ms_fine = statistics.median(admm[1:]), statistics.median(fine)
    ms_update = statistics.mean(upd) - statistics.mean(plain)
    tokens = args.batch * args.seq
    # N from utils.flops (active parameters; all of them in a dense model)
    flops = model_flops(cfg, ShapeConfig("train", args.seq, args.batch, "train"),
                        rep["param_counts"])
    mfu = {k: flops / (ms / 1e3) / PEAK_BF16_FLOPS
           for k, ms in (("admm", ms_admm), ("masked", ms_fine))}
    print(f"  train ({smi}): {cfg.name} {cfg.dtype}, {n_params / 1e9:.3f} B params, "
          f"{sum(m.numel() for m in mflat.values()) / 1e9:.3f} B under ADMM in "
          f"{n_masks} leaves; batch {args.batch} x seq {args.seq}; {len(admm)} ADMM steps "
          f"({rep['n_updates']} Z/U updates) + {len(fine)} masked steps in {wall:.1f}s "
          f"(init included)")
    print(f"  train ms: step 0 {admm[0]:.2f}; ADMM step (median of steps 1-{len(admm) - 1}) "
          f"{ms_admm:.2f}, of which a Z/U update {ms_update:.2f} (update steps "
          f"{statistics.mean(upd):.2f} - others {statistics.mean(plain):.2f}); masked step "
          f"{ms_fine:.2f}; tokens/s {tokens / ms_admm * 1e3:.0f} ADMM, "
          f"{tokens / ms_fine * 1e3:.0f} masked; model-FLOPs utilization (6 N_active T / step / "
          f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s) {mfu['admm']:.1%} ADMM, "
          f"{mfu['masked']:.1%} masked")
    print("  train peak allocated GB: " + ", ".join(
        f"{k} {v / 1e9:.3f}" for k, v in peaks.items())
        + f"; per-step ms {[round(h['ms'], 2) for h in hist]}")
    print(f"  train losses {[round(h['loss'], 4) for h in hist]}; residuals "
          f"{[round(h['primal_residual'], 4) for h in hist if 'primal_residual' in h]}; "
          f"pruned_global {sp:.4f}; max |raw weight| at pruned positions after the fine-tune "
          f"{drift:.3e} (apply_masks zeroes it)")

    # the hand-off: the trained, hard-pruned model through the kernel plans
    del params, hist
    qo = {}
    for i in range(cfg.n_layers):
        for key, node in (("w_q", f"q_{i}"), ("w_o", f"o_{i}")):
            qo[node] = mflat[f"['layers'][{i}]['attn']['{key}']['w']"]
    del masks, mflat
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    block = Block(0.5, bm=64, bn=64)
    pruned = block_pruned_llm(torch, dict(cfg=cfg, params=masked, device=dev), block, masks=qo)
    del masked, qo
    torch.cuda.synchronize()
    graph = pruned["plans"]["decode"].graph
    pbcsr = [n for n in graph.nodes if n.op == "sparse_linear" and n.attrs["format"] == "pbcsr"]
    n_bands = sum(len(n.attrs["bands"]) for n in pbcsr)
    glue = [n.name for n in graph.nodes if n.name.endswith("_unperm")]
    check(len(pbcsr) == 2 * cfg.n_layers and n_bands == 2 * cfg.n_layers and not glue,
          f"train hand-off: {len(pbcsr)} pbcsr nodes, {n_bands} bands, glue {glue[:4]}")
    print(f"  hand-off: hard_prune's q/o masks -> optimize -> {len(pbcsr)} pbcsr nodes "
          f"({n_bands} bands, no glue); compiled in {time.perf_counter() - t0:.1f}s")
    llm_args = argparse.Namespace(smoke=False, **LLM_ARGS)
    torch.cuda.reset_peak_memory_stats()
    launches, _ = serve_llm_checked(
        torch, pruned, llm_args, False, f"{cfg.name} trained+pruned",
        {"dense_matmul_bf16": 3 * cfg.n_layers, "bsr_matmul": n_bands})
    del pruned
    torch.cuda.empty_cache()
    return launches


#: kernel families of a training step, by the kernel's name
_TRAIN_FAMILIES = (("gemm", ("gemm", "xmma", "nvjet", "cutlass", "sm90_", "cublas")),
                   ("reduce", ("reduce",)),
                   ("softmax / logsumexp", ("softmax", "logsumexp")),
                   ("index / sort / topk", ("index", "scatter", "gather", "sort", "topk",
                                            "radix", "embedding")),
                   ("memcpy / memset", ("memcpy", "memset")),
                   ("elementwise", ("elementwise", "vectorized", "unrolled")))


def _train_family(name: str) -> str:
    low = name.lower()
    for fam, keys in _TRAIN_FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def phase_train_profile(torch):
    """Where a full-width training step's device time goes: a second,
    short run (fresh params; steps 0 and 3 unprofiled warm-ups) profiles one
    ADMM step with a Z/U update, one without, and one masked step with
    torch.profiler.  Per step: device busy ms and idle share of the step's
    wall (host clock, synchronized; inflated by the profiler), device ms by
    kernel family, and by part of the step -- forward, the penalty, the
    backward (the rest of ``_value_and_grad``), AdamW (clip and norm
    included), the Z/U update, ``convergence_metrics``, the masks -- from
    ``record_function`` ranges put around the train loop's functions for
    this run only."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.configs import get_config
    from repro_torch.core.pruning import AdmmConfig, hard_prune
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.launch import train
    from repro_torch.models import get_model
    from repro_torch.training import train_loop
    from repro_torch.training.optimizer import AdamWConfig

    dev = torch.device("cuda")
    args = train.build_parser().parse_args(TRAIN_ARGS + ["--device", "cuda"])
    cfg = get_config(args.arch)
    model = get_model(cfg, device=dev)
    parts = {"forward": model.loss}
    for name in ("admm_penalty", "_value_and_grad", "adamw_update", "admm_update",
                 "convergence_metrics", "mask_gradients"):
        parts[name] = getattr(train_loop, name)

    def ranged(name, fn):
        def call(*a, **k):
            with record_function(f"train:{name}"):
                return fn(*a, **k)
        return call

    for name, fn in parts.items():
        if name != "forward":
            setattr(train_loop, name, ranged(name, fn))
    try:
        opt = AdamWConfig(lr=args.lr, total_steps=args.steps, warmup_steps=5)
        acfg = AdmmConfig(rho=1e-2, rho_ramp=1.2, rho_max=1.0, update_every=args.admm_every)
        state = train_loop.init_train_state(
            model.init(torch.Generator(device=dev).manual_seed(args.seed)), opt, admm_cfg=acfg,
            prune_plan=train.default_prune_plan(args.sparsity))
        loss = ranged("forward", parts["forward"])
        step = train_loop.make_train_step(loss, opt, admm_cfg=acfg)
        pipe = SyntheticPipeline(cfg, batch=args.batch, seq=args.seq + 1, seed=args.seed)

        def batch():
            return {k: torch.from_numpy(v).to(dev) for k, v in pipe.next().items()}

        rows = []
        for i in range(5):
            if i == 3:  # hard prune before the masked steps
                pruned, masks = hard_prune(state.params, state.admm)
                state = train_loop.TrainState(params=pruned, opt=state.opt, masks=masks)
                del pruned
                step = train_loop.make_train_step(loss, opt)
            b = batch()
            torch.cuda.synchronize()
            if i in (0, 3):
                state, _ = step(state, b)
                continue
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                state, _ = step(state, b)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            fam, ranges = {}, {}
            for e in prof.key_averages():
                if e.key.startswith("train:"):
                    continue  # the ranges' device-side annotation spans
                if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
                    f = _train_family(e.key)
                    fam[f] = fam.get(f, 0.0) + e.self_device_time_total / 1e3
            for e in prof.events():  # a range's kernels: its host-side event's
                if e.name.startswith("train:") and e.device_type == torch.autograd.DeviceType.CPU:
                    ranges[e.name[6:]] = ranges.get(e.name[6:], 0.0) + e.device_time_total / 1e3
            busy = sum(fam.values())
            check(busy > 0, "train profile: the profiler saw no device time")
            label = {1: "ADMM step with a Z/U update", 2: "ADMM step", 4: "masked step"}[i]
            # the backward's kernels are launched by autograd's device thread,
            # outside every range: they are the rest of the step's busy time
            split = dict(forward=ranges.get("forward", 0.0),
                         penalty=ranges.get("admm_penalty", 0.0))
            for k in ("adamw_update", "admm_update", "convergence_metrics", "mask_gradients"):
                if ranges.get(k):
                    split[k] = ranges[k]
            split["backward"] = busy - sum(split.values())
            print(f"  train profile, {label}: device {busy:.2f} ms of wall {wall:.2f} ms "
                  f"(idle {1 - busy / wall:.0%}); by family "
                  + " ".join(f"{k} {v:.2f} ({v / busy:.0%})"
                             for k, v in sorted(fam.items(), key=lambda kv: -kv[1]))
                  + "; by part " + " ".join(f"{k} {v:.2f}" for k, v in split.items()))
            rows.append(dict(label=label, busy=busy, wall=wall, fam=fam, split=split))
        del state
    finally:
        for name, fn in parts.items():
            if name != "forward":
                setattr(train_loop, name, fn)
    torch.cuda.empty_cache()
    return rows


#: the zoo's training phases (``launch.train`` on the JAX config's width,
#: bf16, seeded): arch -> layers kept, cut only where the training state
#: (bf16 params and grads, f32 Adam m and v, f32 Z and U on the pruned
#: leaves) does not fit one card; ``None`` keeps every layer.
#: deepseek-v2-lite-16b: 1 dense + 5 MoE layers of 27 (191 GB at full
#: depth); recurrentgemma-9b: 3 pattern units of 38 layers (147 GB);
#: qwen3-14b: 6 of 40 (251 GB).  deepseek-v2-236b fits no card: smoke only.
TRAIN_ZOO = {"paligemma-3b": None, "mamba2-1.3b": None, "whisper-small": None,
             "deepseek-v2-lite-16b": 6, "recurrentgemma-9b": 9, "qwen3-14b": 6}
#: 6 steps of 8 x 128 tokens: the hard prune follows step int(6 * 0.5) = 3,
#: so 4 ADMM steps (Z/U updates after steps 1 and 3) and 2 masked steps
TRAIN_ZOO_ARGS = ["--steps", "6", "--batch", "8", "--seq", "128", "--prune", "--sparsity",
                  "0.5", "--admm-every", "2", "--hard-prune-at", "0.5", "--seed", str(SEED)]


def train_zoo_cfg(arch):
    """``arch``'s full config at TRAIN_ZOO's depth."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    depth = TRAIN_ZOO[arch]
    return cfg if depth is None else dataclasses.replace(cfg, n_layers=depth)


def phase_train_zoo(torch, arch, smi):
    """``launch.train.train`` on ``arch`` at full width in bf16
    (TRAIN_ZOO_ARGS, depth from TRAIN_ZOO): finite losses and grad norms,
    the Z/U updates where the JAX condition holds, ``pruned_global`` within
    0.05 of 0.5 (mamba2: exactly 0, the recipe matches none of its leaves),
    masks unchanged by the fine-tune and ``apply_masks`` zero exactly where
    they are, for MoE a finite positive ``aux`` entering the masked steps'
    loss as ``router_aux_weight x aux``.  Prints ms per ADMM / masked step
    (CUDA events), tokens/s, model-FLOPs utilization from the active
    parameters (``utils.flops``) and peak allocated per phase.  Returns the
    numbers it prints."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.pruning import apply_masks
    from repro_torch.launch import train
    from repro_torch.models import get_model
    from repro_torch.utils.flops import model_flops
    from repro_torch.utils.tree import leaves_with_path

    dev = torch.device("cuda")
    cfg = train_zoo_cfg(arch)
    args = train.build_parser().parse_args(["--arch", arch, "--device", "cuda"] + TRAIN_ZOO_ARGS)
    torch.cuda.empty_cache()
    at_prune = {}

    def keep_masks(_, masks):
        at_prune.update((p, m.bool()) for p, m in leaves_with_path(masks))

    t0 = time.perf_counter()
    rep = train.train(args, cfg, get_model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(args.seed)), dev, log=_quiet,
        on_hard_prune=keep_masks)
    wall = time.perf_counter() - t0
    hist, peaks, counts = rep["history"], rep["peak_bytes"], rep["param_counts"]
    label = f"train zoo {arch}"
    check(all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in hist),
          f"{label}: non-finite loss or grad norm {[(h['loss'], h['grad_norm']) for h in hist]}")
    want = [(h["step"] + 1) % args.admm_every == 0 and h["phase"] == "admm" for h in hist]
    check([h["update"] for h in hist] == want and rep["n_updates"] == sum(want) > 0,
          f"{label}: Z/U updates {[h['update'] for h in hist]}, n_updates {rep['n_updates']}")
    sp = rep["sparsity"]["pruned_global"]
    if cfg.ssm is not None:  # the recipe's globs match no Mamba-2 leaf, as in JAX
        check(sp == 0.0 and not at_prune, f"{label}: pruned_global {sp}, masks {len(at_prune)}")
    else:
        check(abs(sp - 0.5) <= 0.05, f"{label}: pruned_global {sp}")
    state, masks = rep.pop("state"), rep.pop("masks")
    mflat = dict(leaves_with_path(masks))
    check(mflat.keys() == at_prune.keys() and all(
        torch.equal(mflat[p].bool(), at_prune[p]) for p in mflat),
          f"{label}: masks changed during the fine-tune")
    experts = [p for p in mflat if "['experts']" in p]
    check(not experts, f"{label}: an expert stack was pruned: {experts[:2]}")
    n_zero = 0
    for path, w in leaves_with_path(apply_masks(state.params, masks)):
        m = mflat.get(path)
        if m is not None:
            check(bool((w[m == 0] == 0).all()), f"{label}: {path} nonzero where masked")
            n_zero += int((m == 0).sum())
    del state, masks, at_prune
    aux = [h.get("aux") for h in hist]
    if cfg.moe is not None:
        w = cfg.moe.router_aux_weight
        check(all(np.isfinite(a) and a > 0 for a in aux), f"{label}: aux {aux}")
        # the masked steps' loss is ce + w * aux (no ADMM penalty), in f32
        bad = [(h["loss"], h["ce"], h["aux"]) for h in hist if h["phase"] == "masked"
               and abs(h["loss"] - (h["ce"] + w * h["aux"])) > 2e-6 * abs(h["loss"])]
        check(not bad, f"{label}: loss != ce + {w} x aux in {bad}")
    admm = [h["ms"] for h in hist if h["phase"] == "admm"]
    fine = [h["ms"] for h in hist if h["phase"] == "masked"]
    ms_admm, ms_fine = statistics.median(admm[1:]), statistics.median(fine)
    tokens = args.batch * args.seq
    flops = model_flops(cfg, ShapeConfig("train", args.seq, args.batch, "train"), counts)
    mfu = {k: flops / (ms / 1e3) / PEAK_BF16_FLOPS for k, ms in (("admm", ms_admm),
                                                                 ("masked", ms_fine))}
    gb = {k: v / 1e9 for k, v in peaks.items()}
    full = get_config(arch)
    depth = (f"{cfg.n_layers} of {full.n_layers} layers" + (
        f" + {cfg.encoder_layers} of {full.encoder_layers} encoder layers" if cfg.is_encdec
        else ""))
    print(f"  {arch} ({smi}): {depth}, {counts['total'] / 1e9:.3f} B params "
          f"({counts['active'] / 1e9:.3f} B active), {sum(m.numel() for m in mflat.values()) / 1e9:.3f}"
          f" B under ADMM in {len(mflat)} leaves; {len(admm)} ADMM steps ({rep['n_updates']} Z/U "
          f"updates) + {len(fine)} masked in {wall:.1f}s (init included)")
    print(f"  {arch} ms: step 0 {admm[0]:.2f}; ADMM step (median of steps 1-{len(admm) - 1}) "
          f"{ms_admm:.2f}, masked step {ms_fine:.2f}; tokens/s {tokens / ms_admm * 1e3:.0f} ADMM, "
          f"{tokens / ms_fine * 1e3:.0f} masked; model-FLOPs utilization (6 N_active T / step / "
          f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s) {mfu['admm']:.1%} ADMM, {mfu['masked']:.1%} "
          f"masked; peak allocated GB " + ", ".join(f"{k} {v:.3f}" for k, v in gb.items()))
    print(f"  {arch} losses {[round(h['loss'], 4) for h in hist]}; pruned_global {sp:.4f}, "
          f"{n_zero} masked weights zero after the fine-tune"
          + (f"; aux {[round(a, 4) for a in aux]} (x {cfg.moe.router_aux_weight} in the loss)"
             if cfg.moe is not None else ""))
    torch.cuda.empty_cache()
    return dict(arch=arch, layers=cfg.n_layers, total=counts["total"], active=counts["active"],
                ms_admm=ms_admm, ms_fine=ms_fine, tok_admm=tokens / ms_admm * 1e3,
                tok_fine=tokens / ms_fine * 1e3, mfu=mfu, peak_gb=gb, sparsity=sp,
                losses=[h["loss"] for h in hist])


#: remat check: card grads with and without remat within this x max(1, max|g|)
REMAT_RTOL = 1e-3


def phase_train_remat(torch):
    """whisper-small at full width, batch 8 x 128 tokens over 1500
    frames: one ``loss_fn`` + backward (``train_loop._value_and_grad``, the
    gradient half of ``make_train_step``) with ``remat=False`` and one with
    ``remat=True``, from the same params: every gradient leaf within
    REMAT_RTOL x max(1, max|g|) of the other, the ``remat=True`` peak
    allocated below the ``remat=False`` one; then one ``make_train_step``
    step each on the loss lambda (the same loss and grad norm)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.models import encdec, get_model
    from repro_torch.training import train_loop
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.utils.tree import leaves_with_path, tree_map

    dev = torch.device("cuda")
    cfg = get_config("whisper-small")
    params = get_model(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(SEED))
    b = SyntheticPipeline(cfg, batch=8, seq=129, seed=SEED).next()
    b = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
    opt = AdamWConfig(lr=1e-3, total_steps=10, warmup_steps=5)
    out = {}
    for remat in (False, True):
        def loss(p, bb, remat=remat):
            return encdec.loss_fn(p, cfg, bb, remat=remat)

        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        state = train_loop.TrainState(params=params, opt=None)
        value, _, grads = train_loop._value_and_grad(loss, state, b)
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        step_state = train_loop.init_train_state(tree_map(torch.clone, params), opt)
        _, m = train_loop.make_train_step(loss, opt)(step_state, b)
        out[remat] = dict(loss=value.item(), grads=grads, peak=peak,
                          step=(m["loss"].item(), m["grad_norm"].item()))
        del step_state, state
    worst = 0.0
    for (path, a), (_, g) in zip(leaves_with_path(out[False]["grads"]),
                                 leaves_with_path(out[True]["grads"])):
        a, g = a.float(), g.float()
        err = float((a - g).abs().max()) / max(1.0, float(a.abs().max()))
        worst = max(worst, err)
        check(err <= REMAT_RTOL, f"train remat: {path} off by {err:.3g} x max(1, max|g|)")
    lo, hi = out[True]["peak"], out[False]["peak"]
    check(lo < hi, f"train remat: peak {lo:.3f} GB with remat, {hi:.3f} without")
    (l0, n0), (l1, n1) = out[False]["step"], out[True]["step"]
    check(abs(l0 - l1) <= 1e-3 * abs(l0) and abs(n0 - n1) <= 1e-3 * abs(n0),
          f"train remat: make_train_step loss / grad norm {l0} / {n0} vs {l1} / {n1}")
    print(f"  remat ({cfg.name}, batch 8 x 128 tokens, {cfg.encoder_seq} frames): one "
          f"loss_fn + backward, peak allocated above the params {hi:.3f} GB without remat, "
          f"{lo:.3f} GB with ({lo / hi:.0%}); grads within {worst:.2e} x max(1, max|g|) (tolerance {REMAT_RTOL}); loss "
          f"{out[False]['loss']:.6f} / {out[True]['loss']:.6f}; make_train_step loss / grad norm "
          f"{l0:.6f} / {n0:.4f} without, {l1:.6f} / {n1:.4f} with")
    del params, out
    torch.cuda.empty_cache()
    return dict(peak_gb=hi, remat_peak_gb=lo, worst=worst)


#: == mesh: the (data, model) mesh by card count, the model and its batch,
#: the ring matmul's shape and the pipeline's depth / width / microbatches
MESH_SHAPES = {1: (1, 1), 2: (1, 2), 4: (2, 2), 8: (2, 4)}
MESH_ARGS = dict(arch="qwen2.5-3b", batch=8, seq=128, steps=3, ring=(1024, 2048, 11008),
                 pipe_layers=36, pipe_d=2048, pipe_micro=4, pipe_rows=256)
#: the sharded losses against the unsharded step's, with more than one card
MESH_LOSS_RTOL = 1e-3
#: the ADMM run's Z/U update interval: once in its three steps
MESH_ADMM_EVERY = 2
#: seconds: the ranks' process-group timeout, and the dry-run cell's limit
MESH_TIMEOUT_S = 300
DRYRUN_TIMEOUT_S = 420
#: == mesh's MoE rows: the arch (at TRAIN_ZOO's depth) under FSDP_RULES, and
#: its decode run: rows, prompt tokens, cache slots, decode steps
MESH_MOE_ARCH = "deepseek-v2-lite-16b"
MESH_DECODE = dict(batch=8, prompt=16, max_len=64, steps=3)
#: == mesh's ssm rows: the arch (at TRAIN_ZOO's depth) under DEFAULT_RULES,
#: its Mamba-2 mixers tensor-parallel over ``model`` (``sharding.on_mixer``)
MESH_SSM_ARCH = "mamba2-1.3b"
#: == mesh's Engine row: the arch at full width and depth under
#: DEFAULT_RULES, its rows, prompt tokens, new tokens and cache slots
MESH_ENGINE = dict(arch="qwen2.5-3b", batch=8, prompt=16, new=8, max_len=64)
#: == mesh's scheduler row, over MESH_ENGINE's model and slots: requests,
#: their prompt lengths and their range of new tokens
MESH_SCHED = dict(requests=16, prompts=(8, 16), new=(4, 8))
#: the dry-run cells == mesh runs: (arch, shape)
DRYRUN_CELLS = (("qwen2.5-3b", "train_4k"), ("qwen3-14b", "decode_32k"),
                ("mamba2-1.3b", "decode_32k"))


def _mesh_train(torch, cfg, dev, mesh, margs, sharded, admm=False, rules=None):
    """``margs["steps"]`` train steps from the seeded init: ``(losses, ms,
    peak GB, params, batch, loss_fn, admm_out)``; ``sharded`` places params
    (by ``rules``, ``DEFAULT_RULES`` if None), ZeRO-1 moments and the batch
    on ``mesh``.  ``admm`` runs the paper's
    recipe (``default_prune_plan(0.5)``, ``update_every=MESH_ADMM_EVERY``,
    Z and U placed like the params), then ``hard_prune`` and one masked
    step; ``admm_out`` holds the masked step's loss and ms, the Z/U
    updates' ms, ``n_updates``, the masks (bool, on the host) and whether
    every U has its weight's local shape (``None`` without ``admm``)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.core.pruning.admm import AdmmConfig, hard_prune
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.launch.train import default_prune_plan
    from repro_torch.models import get_model
    from repro_torch.models import sharding
    from repro_torch.training import optimizer, train_loop
    from repro_torch.utils.tree import leaves, map_with_path

    model = get_model(cfg, device=dev)
    ocfg = optimizer.AdamWConfig(lr=1e-4, total_steps=10, warmup_steps=2)
    acfg = AdmmConfig(update_every=MESH_ADMM_EVERY) if admm else None
    plan = default_prune_plan(0.5) if admm else None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    if sharded:
        specs = sharding.param_pspecs(params, rules)
        params = sharding.distribute_params(mesh, params, specs=specs)
        mv = optimizer.zero1_pspecs(specs, params, data_size=mesh.size(0))
        state = train_loop.init_train_state(params, ocfg, admm_cfg=acfg, prune_plan=plan)
        state.opt = optimizer.adamw_init(params, ocfg, mesh=mesh, moment_specs=mv)
    else:
        state = train_loop.init_train_state(params, ocfg, admm_cfg=acfg, prune_plan=plan)
    step = train_loop.make_train_step(model.loss, ocfg, admm_cfg=acfg)
    pipe = SyntheticPipeline(cfg, batch=margs["batch"], seq=margs["seq"] + 1, seed=SEED)
    update_ms = []
    admm_update = train_loop.admm_update

    def timed_update(*args, **kw):  # the Z/U update inside the step, on the device clock
        _sync(torch, dev)
        t0 = time.perf_counter()
        out = admm_update(*args, **kw)
        _sync(torch, dev)
        update_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def run(step, state):
        b = {k: torch.from_numpy(v).to(dev) for k, v in pipe.next().items()}
        if sharded:
            b = {k: distribute_tensor(v, mesh, [Shard(0), Replicate()]) for k, v in b.items()}
        t0 = time.perf_counter()
        state, m = step(state, b)
        loss = m["loss"].full_tensor() if sharding.is_dtensor(m["loss"]) else m["loss"]
        loss = loss.detach().float().cpu()  # a host sync ends the step
        return state, b, loss, (time.perf_counter() - t0) * 1e3

    losses, ms = [], []
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    train_loop.admm_update = timed_update
    try:
        for _ in range(margs["steps"]):
            state, b, loss, t = run(step, state)
            losses.append(loss)
            ms.append(t)
    finally:
        train_loop.admm_update = admm_update
    admm_out = None
    if admm:
        local = lambda t: t.to_local() if sharding.is_dtensor(t) else t  # noqa: E731
        u_local = all(local(u).shape == local(w).shape for w, u in zip(
            leaves(map_with_path(lambda _, w, u: None if u is None else w, state.params,
                                 state.admm.u)),
            leaves(state.admm.u)))
        n_updates = state.admm.n_updates
        pruned, masks = hard_prune(state.params, state.admm)
        state = train_loop.TrainState(pruned, state.opt, None, masks)
        del pruned
        state, b, masked_loss, masked_ms = run(train_loop.make_train_step(model.loss, ocfg), state)
        full = lambda t: t.full_tensor() if sharding.is_dtensor(t) else t  # noqa: E731
        admm_out = dict(masked_loss=masked_loss, masked_ms=masked_ms, update_ms=update_ms,
                        n_updates=n_updates, u_local=u_local,
                        masks=[full(m).bool().cpu() for m in leaves(masks)])
        del masks
    peak = torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else 0.0
    return losses, ms, peak, state.params, b, model.loss, admm_out


def mesh_rank(rank, world, rdzv, out_path, device, smoke):
    """One rank of ``== mesh`` (``torch.multiprocessing`` target); rank 0
    writes the results to ``out_path`` as JSON."""
    import datetime

    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist

    if device == "cuda":
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device, rank) if device == "cuda" else torch.device("cpu")
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"file://{rdzv}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    try:
        out = _mesh_rank_body(torch, dist, dev, world, smoke)
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(out, f)
    finally:
        dist.destroy_process_group()


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _mesh_rank_body(torch, dist, dev, world, smoke):
    from torch.distributed.tensor import Replicate, distribute_tensor
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import get_model, sharding
    from repro_torch.training import compression, train_loop
    from repro_torch.training.collective_matmul import make_overlapped_tp_matmuls
    from repro_torch.training.pipeline_parallel import pipeline_forward
    from repro_torch.utils.tree import leaves

    margs = dict(MESH_ARGS)
    if smoke:  # the CPU rehearsal's sizes
        margs.update(batch=8, seq=32, ring=(16, 32, 24), pipe_layers=8, pipe_d=16,
                     pipe_rows=4)
    cfg = smoke_config(margs["arch"]) if smoke else get_config(margs["arch"])
    shape = MESH_SHAPES[world]
    out = {"world": world, "mesh": list(shape), "backend": str(dist.get_backend())}

    # the train step, unsharded then sharded, from the same seed
    plain, plain_ms, plain_peak, _, _, _, _ = _mesh_train(torch, cfg, dev, None, margs, False)
    mesh = make_mesh(shape, ("data", "model"), device=dev.type)
    losses, ms, peak, params, batch, loss_fn, _ = _mesh_train(torch, cfg, dev, mesh, margs,
                                                               True)
    out["losses"] = [float(x) for x in losses]
    out["plain_losses"] = [float(x) for x in plain]
    out["equal"] = all(bool(torch.equal(a, b)) for a, b in zip(losses, plain))
    out["ms"], out["plain_ms"] = ms, plain_ms
    peaks = torch.tensor([peak], device=dev)
    dist.all_reduce(peaks, op=dist.ReduceOp.MAX)
    out["peak_gb"], out["plain_peak_gb"] = float(peaks), plain_peak
    w = params["layers"][0]["ffn"]["w_gate"]["w"]
    out["w_gate_local"] = [list(w.shape), list(w.to_local().shape)]
    with CommDebugMode() as comm:
        train_loop._value_and_grad(loss_fn, train_loop.TrainState(params, None), batch)
    out["collectives"] = {str(k).split(".")[-1]: int(v)
                          for k, v in comm.get_comm_counts().items()}
    del params, batch, w

    # the paper's ADMM recipe, unsharded then sharded, from the same seed
    out["admm"] = {}
    for sharded in (False, True):
        losses, ms, peak, _, _, _, a = _mesh_train(torch, cfg, dev, mesh if sharded else None,
                                                   margs, sharded, admm=True)
        peaks = torch.tensor([peak], device=dev)
        dist.all_reduce(peaks, op=dist.ReduceOp.MAX)
        out["admm"]["sharded" if sharded else "plain"] = dict(
            losses=[float(x) for x in losses + [a["masked_loss"]]], ms=ms,
            masked_ms=a["masked_ms"], update_ms=a["update_ms"], n_updates=a["n_updates"],
            u_local=a["u_local"], peak_gb=float(peaks))
        if not sharded:
            plain_admm, plain_masks = losses + [a["masked_loss"]], a["masks"]
        else:
            out["admm"]["equal"] = all(bool(torch.equal(x, y)) for x, y in zip(
                losses + [a["masked_loss"]], plain_admm))
            out["admm"]["masks_equal"] = len(a["masks"]) == len(plain_masks) > 0 and all(
                bool(torch.equal(x, y)) for x, y in zip(a["masks"], plain_masks))
            out["admm"]["n_masks"] = len(a["masks"])
            out["admm"]["sparsity"] = 1.0 - sum(int(x.sum()) for x in a["masks"]) / sum(
                x.numel() for x in a["masks"])
        del a
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    del plain_masks

    out["moe"] = _mesh_model(torch, dist, dev, mesh, margs, smoke, MESH_MOE_ARCH,
                             sharding.FSDP_RULES)
    out["ssm"] = _mesh_model(torch, dist, dev, mesh, margs, smoke, MESH_SSM_ARCH, None)
    out["engine"] = _mesh_engine(torch, dev, mesh, smoke)

    # compression: each data rank's gradient of its batch shard, on a 1-D mesh
    dmesh = make_mesh((world,), ("data",), device=dev.type)
    params = get_model(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(SEED))
    full = SyntheticPipeline(cfg, batch=margs["batch"], seq=margs["seq"] + 1, seed=SEED).next()
    rows = margs["batch"] // world
    r = dist.get_rank()
    b = {k: torch.from_numpy(v[r * rows:(r + 1) * rows]).to(dev) for k, v in full.items()}
    _, _, grads = train_loop._value_and_grad(get_model(cfg).loss,
                                             train_loop.TrainState(params, None), b)
    del params
    gl = leaves(grads)
    out["compression"] = {}
    for policy in ("int8", "topk"):
        ccfg = compression.CompressionConfig(policy, topk_frac=0.01)
        apply = compression.make_compressed_allreduce(dmesh, grads, cfg=ccfg)
        err0 = compression.init_error_feedback(grads)
        _sync(torch, dev)
        t0 = time.perf_counter()
        means, _ = apply(grads, err0)
        _sync(torch, dev)
        wall = (time.perf_counter() - t0) * 1e3
        del err0
        worst, within = 0.0, True
        for g, m in zip(gl, leaves(means)):
            ref = g.float().clone()
            dist.all_reduce(ref, group=dmesh.get_group(0))
            ref /= world
            gmax = g.float().abs().max().reshape(1)
            dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=dmesh.get_group(0))
            e = float((m - ref).abs().max())
            worst = max(worst, e / max(float(ref.abs().max()), 1e-30))
            # int8: each rank's rounding moves a value by half a step at most
            within = within and (policy != "int8" or e <= float(gmax) / 254 * 1.0001 + 1e-12)
        del means
        sent, ring = compression.wire_bytes(grads, world, ccfg)
        sent8, ring8 = compression.wire_bytes(grads, 8, ccfg)
        payload = sum(g.numel() + 4 for g in gl) if policy == "int8" else sum(
            4 * g.numel() for g in gl)
        out["compression"][policy] = dict(
            max_rel_err=worst, within_half_step=within, ms=wall, wire_bytes=sent,
            f32_allreduce_bytes=ring, wire_bytes_8=sent8, f32_allreduce_bytes_8=ring8,
            payload_bytes=payload,
            f32_payload_bytes=sum(4 * g.numel() for g in gl))
    del grads, gl

    # the ring matmuls on a 1-D model mesh, bf16
    mm, kk, nn = margs["ring"]
    mmesh = make_mesh((world,), ("model",), device=dev.type)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    dt = torch.bfloat16 if dev.type == "cuda" else torch.float32
    x = torch.randn(mm, kk, generator=gen, device=dev).to(dt)
    wt = (torch.randn(kk, nn, generator=gen, device=dev) * kk ** -0.5).to(dt)
    ref = (x.float() @ wt.float()).to(dt)
    ag, rs = make_overlapped_tp_matmuls(mmesh)
    xd = distribute_tensor(x, mmesh, [Replicate()])
    wd = distribute_tensor(wt, mmesh, [Replicate()])
    out["ring"] = {}
    for name, fn in (("ag", ag), ("rs", rs)):
        y = fn(xd, wd).full_tensor()
        err = float((y.float() - ref.float()).abs().max())
        times = []
        for _ in range(5):
            _sync(torch, dev)
            t0 = time.perf_counter()
            fn(xd, wd)
            _sync(torch, dev)
            times.append((time.perf_counter() - t0) * 1e3)
        out["ring"][name] = dict(max_abs_err=err, ref_max=float(ref.float().abs().max()),
                                 ms=statistics.median(times))
    _sync(torch, dev)
    t0 = time.perf_counter()
    for _ in range(5):
        x @ wt
    _sync(torch, dev)
    out["ring"]["matmul_ms"] = (time.perf_counter() - t0) * 1e3 / 5
    del x, wt, xd, wd, ref

    # GPipe on a 1-D pipe mesh, f32: the layers a stage a multiple of the world
    layers = margs["pipe_layers"] - margs["pipe_layers"] % world
    d, m_, rows_ = margs["pipe_d"], margs["pipe_micro"], margs["pipe_rows"]
    pmesh = make_mesh((world,), ("pipe",), device=dev.type)
    wp = torch.randn(layers, d, d, generator=gen, device=dev) * d ** -0.5
    xm = torch.randn(m_, rows_, d, generator=gen, device=dev)

    def layer(lp, h):
        return torch.tanh(h @ lp["w"])

    with torch.no_grad():
        _sync(torch, dev)
        t0 = time.perf_counter()
        got = pipeline_forward(layer, {"w": wp}, xm, mesh=pmesh)
        _sync(torch, dev)
        pipe_ms = (time.perf_counter() - t0) * 1e3
        seq = []
        for i in range(m_):  # the sequential loop, microbatch by microbatch
            h = xm[i]
            for j in range(layers):
                h = layer({"w": wp[j]}, h)
            seq.append(h)
        seq = torch.stack(seq)
    out["pipe"] = dict(layers=layers, equal=bool(torch.equal(got, seq)),
                       max_abs_err=float((got - seq).abs().max()), ms=pipe_ms)
    return out


def _mesh_prefill(torch, dev, mesh, params, dp, cfg, prompt, max_len):
    """``transformer.prefill`` of ``prompt`` into ``max_len`` slots on the
    plain params, then on their DTensors ``dp`` with the prompt cut over the
    batch (``sharding.place_rows``): ``(plain caches, sharded caches,
    record)``, the record holding each run's ms (host clock, synced),
    whether the logits and every cache leaf are ``torch.equal`` (else the
    worst error relative to each one's max), and whether every leaf lies in
    its ``cache_pspecs`` placements with the local shape those give it.
    Deterministic algorithms are on (the MoE dispatch's sums)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.models import sharding
    from repro_torch.models import transformer as tlm
    from repro_torch.utils.tree import leaves, map_with_path

    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    ms, runs = [], []
    try:
        for p, tok in ((params, prompt), (dp, sharding.place_rows(prompt, mesh))):
            _sync(torch, dev)
            t0 = time.perf_counter()
            with torch.no_grad():
                lg, caches = tlm.prefill(p, cfg, tok, max_len)
            _sync(torch, dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            runs.append((lg, caches))
    finally:
        torch.use_deterministic_algorithms(deterministic)
    (lg, caches), (dlg, dcaches) = runs
    whole = lambda t: t.full_tensor() if sharding.is_dtensor(t) else t  # noqa: E731
    pairs = [(whole(dlg), lg)] + [(whole(a), b) for a, b in zip(leaves(dcaches), leaves(caches))]
    specs = sharding.cache_pspecs(caches, mesh)
    want = map_with_path(lambda _, t, s: distribute_tensor(
        t, mesh, sharding.param_placements(mesh, s), src_data_rank=None), caches, specs)
    layout = lambda tree: [(tuple(t.placements), tuple(t.to_local().shape))  # noqa: E731
                           for t in leaves(tree)]
    rec = dict(ms=ms[1], plain_ms=ms[0],
               equal=all(bool(torch.equal(a, b)) for a, b in pairs),
               max_rel_err=max(float((a.float() - b.float()).abs().max())
                               / max(float(b.float().abs().max()), 1e-30) for a, b in pairs),
               placed=layout(dcaches) == layout(want), leaves=len(pairs) - 1)
    del want, dlg, lg
    return caches, dcaches, rec


def _mesh_model(torch, dist, dev, mesh, margs, smoke, arch, rules):
    """``arch`` at TRAIN_ZOO's depth (its smoke config with ``smoke``) under
    ``rules`` (``DEFAULT_RULES`` if None): the train step unsharded then
    sharded (losses, ms, peak GB a rank), then MESH_DECODE's prefill
    unsharded and on the sharded params (``_mesh_prefill``) and its decode
    steps from each one's caches (logits, whether every cache leaf kept its
    placements, ms a step)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import get_model
    from repro_torch.models import sharding
    from repro_torch.utils.tree import leaves

    cfg = smoke_config(arch) if smoke else train_zoo_cfg(arch)
    # the dispatch's gathers read each token once an expert: their backward
    # sums those reads with atomics on the card unless told to keep an order
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        plain, plain_ms, plain_peak, _, _, _, _ = _mesh_train(torch, cfg, dev, None, margs,
                                                              False)
        losses, ms, peak, _, _, _, _ = _mesh_train(torch, cfg, dev, mesh, margs, True,
                                                   rules=rules)
    finally:
        torch.use_deterministic_algorithms(deterministic)
    peaks = torch.tensor([peak], device=dev)
    dist.all_reduce(peaks, op=dist.ReduceOp.MAX)
    out = dict(arch=arch, layers=cfg.n_layers,
               full_layers=get_config(arch).n_layers, losses=[float(x) for x in losses],
               plain_losses=[float(x) for x in plain], ms=ms, plain_ms=plain_ms,
               peak_gb=float(peaks), plain_peak_gb=plain_peak,
               equal=all(bool(torch.equal(a, b)) for a, b in zip(losses, plain)))
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    md = MESH_DECODE
    model = get_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    prompt = torch.randint(0, cfg.vocab, (md["batch"], md["prompt"]), generator=gen, device=dev)
    steps = torch.randint(0, cfg.vocab, (md["batch"], md["steps"]), generator=gen, device=dev)
    dp = sharding.distribute_params(mesh, params, rules)
    caches, placed, out["prefill"] = _mesh_prefill(torch, dev, mesh, params, dp, cfg, prompt,
                                                   md["max_len"])
    rows = sharding.param_placements(mesh, sharding.batch_spec(mesh))
    layout = lambda tree: [(tuple(t.placements), tuple(t.to_local().shape))  # noqa: E731
                           for t in leaves(tree)]
    given = layout(placed)
    logits, kept, times = {}, [], {"plain": [], "sharded": []}
    for name, p, c in (("plain", params, caches), ("sharded", dp, placed)):
        logits[name] = []
        for t in range(md["steps"]):
            tok = steps[:, t:t + 1]
            if name == "sharded":
                tok = distribute_tensor(tok, mesh, rows)
            _sync(torch, dev)
            t0 = time.perf_counter()
            with torch.no_grad():
                lg, c = model.decode_step(p, {"tokens_t": tok}, c)
            lg = lg.full_tensor() if sharding.is_dtensor(lg) else lg
            _sync(torch, dev)
            times[name].append((time.perf_counter() - t0) * 1e3)
            logits[name].append(lg.float().cpu())
            if name == "sharded":
                kept.append(layout(c) == given)
    out["decode"] = dict(
        equal=all(bool(torch.equal(a, b)) for a, b in zip(logits["sharded"], logits["plain"])),
        max_abs_err=max(float((a - b).abs().max())
                        for a, b in zip(logits["sharded"], logits["plain"])),
        ref_max=max(float(b.abs().max()) for b in logits["plain"]),
        finite=all(bool(torch.isfinite(x).all()) for x in logits["sharded"]),
        kept=kept, ms=times["sharded"], plain_ms=times["plain"],
        cut=sorted({repr(pl) for pl, _ in given}))
    del params, dp, caches, placed, c
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _mesh_engine(torch, dev, mesh, smoke):
    """MESH_ENGINE's arch (bf16, full width and depth; its smoke config with
    ``smoke``) under ``DEFAULT_RULES``: its prefill unsharded and on the
    sharded params (``_mesh_prefill``), then ``Engine.generate`` on the
    plain params and on their DTensors: each run's greedy tokens and tok/s
    (the new tokens of every row over the host clock's seconds of the whole
    call, synced), and after each sharded decode step whether every cache
    leaf came back in the placements and local shape it went in with."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import get_model, sharding
    from repro_torch.serving.engine import Engine
    from repro_torch.utils.tree import leaves

    me = MESH_ENGINE
    cfg = smoke_config(me["arch"]) if smoke else get_config(me["arch"])
    model = get_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    prompt = torch.randint(0, cfg.vocab, (me["batch"], me["prompt"]), generator=gen, device=dev)
    dp = sharding.distribute_params(mesh, params)
    _, _, out = _mesh_prefill(torch, dev, mesh, params, dp, cfg, prompt, me["max_len"])
    out["layers"] = cfg.n_layers
    layout = lambda tree: [(tuple(t.placements), tuple(t.to_local().shape))  # noqa: E731
                           for t in leaves(tree)]
    kept, tokens = [], {}
    for name, p in (("plain", params), ("sharded", dp)):
        eng = Engine(model, p, batch_size=me["batch"], max_len=me["max_len"])
        if name == "sharded":
            decode = eng._decode

            def checked(pp, tok, caches, decode=decode):
                lg, new = decode(pp, tok, caches)
                kept.append(layout(new) == layout(caches))
                return lg, new

            eng._decode = checked
        _sync(torch, dev)
        t0 = time.perf_counter()
        tokens[name] = eng.generate(prompt, me["new"]).tokens
        _sync(torch, dev)
        out[f"{name}_tok_s"] = me["batch"] * me["new"] / (time.perf_counter() - t0)
    out["tokens_equal"] = bool((tokens["plain"] == tokens["sharded"]).all())
    out["tokens"] = tokens["sharded"][0].tolist()
    out["kept"] = kept
    out["sched"] = _mesh_scheduler(torch, dev, mesh, model, params, dp)
    del params, dp
    gc.collect()  # an engine whose wrapped steps refer back to it holds its params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _mesh_scheduler(torch, dev, mesh, model, params, dp):
    """``RequestScheduler`` over an ``Engine`` of MESH_ENGINE's slots on the
    plain params and on their DTensors ``dp``, MESH_SCHED's requests drawn
    from SEED: each request's tokens and whether it was served to its
    ``max_new``, the plain logits' top-two gap and max |logits| behind each
    token (the near-tie rule reads them), the run's ms and tok/s (host
    clock, synced), and at each sharded tick whether every cache leaf -- as
    spliced and as the decode step returns it -- has its ``cache_pspecs``
    placements and ``batch / data`` local rows."""
    from repro_torch.models import sharding
    from repro_torch.serving.engine import Engine, Request, RequestScheduler
    from repro_torch.utils.tree import leaves

    me, ms = MESH_ENGINE, MESH_SCHED
    rng = np.random.default_rng(SEED + 3)
    lens = rng.choice(ms["prompts"], ms["requests"])
    news = rng.integers(ms["new"][0], ms["new"][1] + 1, ms["requests"])
    asks = [(rng.integers(0, model.cfg.vocab, int(n)).astype(np.int32), int(m))
            for n, m in zip(lens, news)]
    rows = me["batch"] // mesh.size(0)

    def in_place(caches):
        specs = leaves(sharding.cache_pspecs(caches, mesh))
        return all(tuple(t.placements) == tuple(sharding.param_placements(mesh, sp))
                   and t.to_local().shape[0] == rows for t, sp in zip(leaves(caches), specs))

    out, kept, seen = {}, [], []
    for name, p in (("plain", params), ("sharded", dp)):
        eng = Engine(model, p, batch_size=me["batch"], max_len=me["max_len"])
        sched = RequestScheduler(eng)
        reqs = [Request(j, prompt, n) for j, (prompt, n) in enumerate(asks)]
        if name == "plain":  # each call's top two and max |logits|, left on the device
            prefill, decode, admitted = eng._prefill, eng._decode, iter(reqs)

            def record(rids, lg):
                seen.append((rids, lg.float().topk(2, dim=-1).values, lg.float().abs().amax(-1)))

            def prefilled(pp, tok, pe=None, prefill=prefill, admitted=admitted):
                lg, caches = prefill(pp, tok, pe)
                record([next(admitted).rid], lg)
                return lg, caches

            def decoded(pp, tok, caches, decode=decode, sched=sched):
                lg, new = decode(pp, tok, caches)
                record([r.rid if r is not None and not r.done else None for r in sched.slots],
                       lg)
                return lg, new

            eng._prefill, eng._decode = prefilled, decoded
        else:
            decode = eng._decode

            def checked(pp, tok, caches, decode=decode):
                lg, new = decode(pp, tok, caches)
                kept.append(in_place(caches) and in_place(new))
                return lg, new

            eng._decode = checked
        for r in reqs:
            sched.submit(r)
        _sync(torch, dev)
        t0 = time.perf_counter()
        sched.run()
        _sync(torch, dev)
        wall = time.perf_counter() - t0
        n = sum(len(r.generated) for r in reqs)
        out[name] = dict(tokens=[r.generated for r in reqs], ms=wall * 1e3, tok_s=n / wall,
                         served=all(r.done and len(r.generated) == r.max_new for r in reqs),
                         n_tokens=n)
    gaps = {j: [] for j in range(ms["requests"])}
    for rids, top, mx in seen:
        top, mx = top.cpu().tolist(), mx.cpu().tolist()
        for i, j in enumerate(rids):
            if j is not None:
                gaps[j].append((top[i][0] - top[i][1], mx[i]))
    out["kept"] = kept
    out["gaps"] = [gaps[j] for j in range(ms["requests"])]
    return out


def _print_scheduler(sc, world, smi, layers):
    """Check and print ``== mesh``'s scheduler row (``_mesh_scheduler``)."""
    me, ms = MESH_ENGINE, MESH_SCHED
    pl, sd = sc["plain"], sc["sharded"]
    check(pl["served"] and sd["served"], "mesh scheduler: a request was not served to its "
          "max_new")
    check(len(sc["kept"]) > 0 and all(sc["kept"]), f"mesh scheduler: a cache leaf left its "
          f"cache_pspecs placements or local rows at a tick ({sc['kept']})")
    differ = [j for j, (a, b) in enumerate(zip(pl["tokens"], sd["tokens"])) if a != b]
    if world == 1:
        check(not differ, f"mesh scheduler: requests {differ} differ from the unsharded "
              f"scheduler's on one card")
    for j in differ:
        t = next(t for t, (a, b) in enumerate(zip(pl["tokens"][j], sd["tokens"][j])) if a != b)
        g, m = sc["gaps"][j][t]
        check(g <= MESH_LOSS_RTOL * m, f"mesh scheduler: request {j} token {t} differs where "
              f"the plain logits' top two are {g:.3e} apart (max |logits| {m:.3e})")
    print(f"  mesh scheduler ({me['arch']}, bf16, full width, {layers} layers, DEFAULT_RULES, "
          f"{smi}): RequestScheduler of {ms['requests']} requests (prompts of "
          f"{' / '.join(map(str, ms['prompts']))} tokens, {ms['new'][0]}-{ms['new'][1]} new "
          f"each, {sd['n_tokens']} tokens) over {me['batch']} slots: tokens "
          f"{'equal' if not differ else f'equal up to near ties ({len(differ)} requests)'} to "
          f"the unsharded scheduler's, none failed, every cache leaf in its cache_pspecs "
          f"placements with {me['batch']} / data local rows at each of {len(sc['kept'])} "
          f"ticks; ms {sd['ms']:.2f} sharded vs {pl['ms']:.2f} unsharded, tok/s "
          f"{sd['tok_s']:.2f} vs {pl['tok_s']:.2f} (host clock, synced, the whole run)")


def _print_prefill(key, pf, world, smi, what):
    """Check and print a ``== mesh`` prefill row (``_mesh_prefill``)."""
    check(pf["placed"], f"mesh {key}: a sharded prefill's cache leaf is off its cache_pspecs "
          f"placements or local shape")
    if world == 1:
        check(pf["equal"], f"mesh {key}: the sharded prefill differs from the unsharded (max "
              f"rel {pf['max_rel_err']:.3e})")
    else:
        check(pf["max_rel_err"] <= MESH_LOSS_RTOL, f"mesh {key}: the sharded prefill is off "
              f"by {pf['max_rel_err']:.3e} x max")
    print(f"  mesh {key} prefill ({what}, {smi}): logits and {pf['leaves']} cache leaves "
          f"{'torch.equal' if pf['equal'] else 'max rel err %.3e' % pf['max_rel_err']} to the "
          f"unsharded prefill's, every leaf in its cache_pspecs placements and local shape; "
          f"ms {pf['ms']:.2f} sharded vs {pf['plain_ms']:.2f} unsharded (host clock, synced)")


def _print_mesh_model(key, mo, rules, world, smi, step_ms):
    """Check and print ``== mesh``'s rows of one model (``_mesh_model``)."""
    dec = mo["decode"]
    lo, pl = mo["losses"], mo["plain_losses"]
    rel = max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(lo, pl))
    check(all(np.isfinite(lo)), f"mesh {key}: non-finite losses {lo}")
    check(dec["finite"], f"mesh {key}: non-finite decode logits")
    check(all(dec["kept"]) and len(dec["kept"]) == MESH_DECODE["steps"],
          f"mesh {key}: a decode step moved a cache leaf off its placements ({dec['kept']})")
    if world == 1:
        check(mo["equal"], f"mesh {key}: sharded losses {lo} differ from the unsharded {pl}")
        check(dec["equal"], f"mesh {key}: sharded decode logits differ from the unsharded "
              f"(max abs {dec['max_abs_err']:.3e})")
    else:
        check(rel <= MESH_LOSS_RTOL, f"mesh {key}: sharded losses {lo} vs unsharded {pl} "
              f"({rel:.2e})")
        check(dec["max_abs_err"] <= MESH_LOSS_RTOL * dec["ref_max"],
              f"mesh {key}: sharded decode logits off by {dec['max_abs_err']:.3e}")
    md = MESH_DECODE
    _print_prefill(key, mo["prefill"], world, smi, f"{mo['arch']}, {mo['layers']} layers, "
                   f"{rules}, {md['batch']} rows of {md['prompt']} tokens into {md['max_len']} "
                   f"slots")
    print(f"  mesh {key} ({mo['arch']}, full width, {mo['layers']} of "
          f"{mo['full_layers']} layers, bf16, {MESH_ARGS['batch']} x {MESH_ARGS['seq']} "
          f"tokens, {rules}, ZeRO-1, {smi}): losses {[round(x, 6) for x in lo]}, unsharded "
          f"{[round(x, 6) for x in pl]} ({'torch.equal' if mo['equal'] else f'max rel {rel:.2e}'});"
          f" ms a step {step_ms(mo):.2f} sharded vs {step_ms(dict(ms=mo['plain_ms'])):.2f} "
          f"unsharded (medians of steps 1-{len(mo['ms']) - 1}; step 0 {mo['ms'][0]:.2f} / "
          f"{mo['plain_ms'][0]:.2f}); peak GB a rank {mo['peak_gb']:.3f} sharded, "
          f"{mo['plain_peak_gb']:.3f} unsharded")
    print(f"  mesh {key} decode ({md['batch']} rows, {md['steps']} steps from each prefill's "
          f"caches, the sharded one's cut {dec['cut']}): logits "
          f"{'torch.equal' if dec['equal'] else 'max abs err %.3e' % dec['max_abs_err']} to the "
          f"unsharded steps', every cache leaf in its placements after each step; ms a step "
          f"{[round(x, 2) for x in dec['ms']]} sharded vs {[round(x, 2) for x in dec['plain_ms']]}"
          f" unsharded (host clock, synced)")


def phase_mesh(torch, smi, *, device="cuda", smoke=False):
    """Phase 18 (see the module docstring).  Spawns the ranks, checks and
    prints their results, then runs the dry-run cell and its roofline row.
    Returns the results."""
    import torch.multiprocessing as mp

    world = torch.cuda.device_count() if device == "cuda" else 4
    check(world in MESH_SHAPES, f"mesh: no (data, model) mesh for {world} cards")
    out_dir = ROOT / "build" / "mesh"
    out_dir.mkdir(parents=True, exist_ok=True)
    rdzv, res = out_dir / "rdzv", out_dir / "result.json"
    for f in (rdzv, res):
        if f.exists():
            f.unlink()
    sys.stdout.flush()
    t0 = time.perf_counter()
    ctx = mp.start_processes(mesh_rank, args=(world, str(rdzv), str(res), device, smoke),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + MESH_TIMEOUT_S + 120
    try:
        while not ctx.join(timeout=5):
            check(time.monotonic() < deadline, "mesh: the ranks did not finish in time")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    wall = time.perf_counter() - t0
    with open(res) as f:
        r = json.load(f)
    lines = "world 1 (one card)" if world == 1 else f"world {world} ({world} cards)"
    lo, pl = r["losses"], r["plain_losses"]
    rel = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(lo, pl))
    check(all(np.isfinite(lo)), f"mesh: non-finite losses {lo}")
    if world == 1:
        check(r["equal"], f"mesh: sharded losses {lo} differ from the unsharded {pl} on one card")
    else:
        check(rel <= MESH_LOSS_RTOL, f"mesh: sharded losses {lo} vs unsharded {pl} ({rel:.2e})")
    ms = statistics.median(r["ms"][1:]) if len(r["ms"]) > 1 else r["ms"][0]
    pms = statistics.median(r["plain_ms"][1:]) if len(r["plain_ms"]) > 1 else r["plain_ms"][0]
    print(f"  mesh ({smi}): {lines}, (data, model) = {tuple(r['mesh'])}, "
          f"{r['backend']}; ranks done in {wall:.1f}s")
    print(f"  mesh train ({MESH_ARGS['arch']}, bf16, {MESH_ARGS['batch']} x {MESH_ARGS['seq']} "
          f"tokens, DEFAULT_RULES, ZeRO-1): losses {[round(x, 6) for x in lo]}, unsharded "
          f"{[round(x, 6) for x in pl]} ({'torch.equal' if r['equal'] else f'max rel {rel:.2e}'}); "
          f"ms a step {ms:.2f} sharded vs {pms:.2f} unsharded (medians of steps 1-"
          f"{len(r['ms']) - 1}; step 0 {r['ms'][0]:.2f} / {r['plain_ms'][0]:.2f}); peak GB a rank "
          f"{r['peak_gb']:.3f} sharded, {r['plain_peak_gb']:.3f} unsharded; w_gate global "
          f"{r['w_gate_local'][0]} local {r['w_gate_local'][1]}; collectives of one forward + "
          f"backward {r['collectives'] or 'none'}")
    for policy, c in r["compression"].items():
        check(np.isfinite(c["max_rel_err"]) and c["within_half_step"],
              f"mesh: {policy} compression error {c}")
        print(f"  mesh compression {policy}: max error vs the f32 mean {c['max_rel_err']:.3e} x "
              f"max|mean| (a leaf's worst); {c['ms']:.1f} ms for the tree; wire bytes a rank "
              f"{c['wire_bytes']:.4g} vs f32 all-reduce {c['f32_allreduce_bytes']:.4g} (reckoned "
              f"for 8 ranks: {c['wire_bytes_8']:.4g} vs {c['f32_allreduce_bytes_8']:.4g}); payload "
              f"{c['payload_bytes'] / 1e9:.3f} GB vs f32 {c['f32_payload_bytes'] / 1e9:.3f} GB")
    for name in ("ag", "rs"):
        c = r["ring"][name]
        # one bf16 rounding of the f32 product, plus the f32 sum's order
        tol = c["ref_max"] * 2.0 ** -7
        check(c["max_abs_err"] <= tol, f"mesh: {name}_matmul off by {c['max_abs_err']} > {tol}")
        print(f"  mesh {name}_matmul M,K,N = {MESH_ARGS['ring']} bf16: max abs err "
              f"{c['max_abs_err']:.3e} (tolerance {tol:.3e}), {c['ms']:.3f} ms (host clock, "
              f"median of 5) vs torch.matmul {r['ring']['matmul_ms']:.3f} ms")
    a, ap, asd = r["admm"], r["admm"]["plain"], r["admm"]["sharded"]
    lo, pl = asd["losses"], ap["losses"]
    rel = max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(lo, pl))
    check(all(np.isfinite(lo)), f"mesh admm: non-finite losses {lo}")
    if world == 1:
        check(a["equal"], f"mesh admm: sharded losses {lo} differ from the unsharded {pl}")
    else:
        check(rel <= MESH_LOSS_RTOL, f"mesh admm: sharded losses {lo} vs unsharded {pl} "
              f"({rel:.2e})")
    check(a["masks_equal"], "mesh admm: the sharded hard-prune masks differ from the unsharded")
    for k, v in (("unsharded", ap), ("sharded", asd)):
        check(v["n_updates"] == 1 and len(v["update_ms"]) == 1,
              f"mesh admm: {k} ran {v['n_updates']} Z/U updates ({v['update_ms']}), not 1")
    check(asd["u_local"], "mesh admm: a U's local shape differs from its weight's")

    def step_ms(v):
        return statistics.median(v["ms"][1:]) if len(v["ms"]) > 1 else v["ms"][0]

    print(f"  mesh admm ({MESH_ARGS['arch']}, bf16, {MESH_ARGS['batch']} x {MESH_ARGS['seq']} "
          f"tokens, default_prune_plan(0.5), update_every={MESH_ADMM_EVERY}, {smi}): losses of "
          f"{len(asd['ms'])} ADMM steps + 1 masked step {[round(x, 6) for x in lo]}, unsharded "
          f"{[round(x, 6) for x in pl]} ({'torch.equal' if a['equal'] else f'max rel {rel:.2e}'});"
          f" hard-prune masks torch.equal ({a['n_masks']} leaves, sparsity {a['sparsity']:.4f});"
          f" U local shape = the weight's; ms a step {step_ms(asd):.2f} sharded vs "
          f"{step_ms(ap):.2f} unsharded (medians of steps 1-{len(asd['ms']) - 1}; step 0 "
          f"{asd['ms'][0]:.2f} / {ap['ms'][0]:.2f}; masked step {asd['masked_ms']:.2f} / "
          f"{ap['masked_ms']:.2f}); Z/U update ms {asd['update_ms'][0]:.2f} sharded vs "
          f"{ap['update_ms'][0]:.2f} unsharded (inside its step); peak GB a rank "
          f"{asd['peak_gb']:.3f} sharded, {ap['peak_gb']:.3f} unsharded")
    for key, rules in (("moe", "FSDP_RULES"), ("ssm", "DEFAULT_RULES")):
        _print_mesh_model(key, r[key], rules, world, smi, step_ms)
    e, me = r["engine"], MESH_ENGINE
    _print_prefill("engine", e, world, smi, f"{me['arch']}, {e['layers']} layers, DEFAULT_RULES,"
                   f" {me['batch']} rows of {me['prompt']} tokens into {me['max_len']} slots")
    check(all(e["kept"]) and len(e["kept"]) == me["new"] - 1,
          f"mesh engine: a decode step moved a cache leaf off its placements ({e['kept']})")
    if world == 1:
        check(e["tokens_equal"], "mesh engine: the sharded Engine's greedy tokens differ from "
              "the unsharded Engine's on one card")
    print(f"  mesh engine ({me['arch']}, bf16, full width, {e['layers']} layers, DEFAULT_RULES, "
          f"{smi}): Engine.generate of {me['new']} tokens for {me['batch']} rows of "
          f"{me['prompt']}: greedy tokens "
          f"{'equal' if e['tokens_equal'] else 'NOT equal'} to the unsharded Engine's (row 0 "
          f"{e['tokens']}), every cache leaf in its placements after each step; tok/s "
          f"{e['sharded_tok_s']:.2f} sharded vs {e['plain_tok_s']:.2f} unsharded (host clock, "
          f"synced, the whole generate call)")
    _print_scheduler(e["sched"], world, smi, e["layers"])
    p = r["pipe"]
    check(p["equal"], f"mesh: pipeline_forward differs from the sequential loop ({p})")
    print(f"  mesh pipeline_forward ({p['layers']} layers of tanh(h @ W), D = "
          f"{MESH_ARGS['pipe_d']}, {MESH_ARGS['pipe_micro']} microbatches of "
          f"{MESH_ARGS['pipe_rows']} rows, f32): torch.equal to the sequential loop, "
          f"{p['ms']:.2f} ms")
    if not smoke:
        r["dryrun"] = [phase_dryrun_cell(smi, arch, shape) for arch, shape in DRYRUN_CELLS]
    return r


def phase_dryrun_cell(smi, arch, shape):
    """``launch.dryrun`` on ``arch`` ``shape`` (the fake 16 x 16 mesh) in a
    subprocess, then its ``launch.roofline`` row."""
    out_dir = ROOT / "build" / "dryrun"
    env = dict(__import__("os").environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                          arch, "--shape", shape, "--mesh", "single", "--force",
                          "--out", str(out_dir)], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=DRYRUN_TIMEOUT_S)
    wall = time.perf_counter() - t0
    check(run.returncode == 0, f"dryrun: rc {run.returncode}\n{run.stdout[-2000:]}"
          f"\n{run.stderr[-2000:]}")
    with open(out_dir / f"{arch}__{shape}__single.json") as f:
        rec = json.load(f)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import roofline

    a = roofline.analyze_record(rec)
    check(a is not None and a["dominant"] in ("compute", "memory", "collective"),
          f"dryrun: no roofline row for {rec.get('error')}")
    m = rec["memory"]
    print(f"  dryrun {arch} {shape} single ({rec['chips']} fake ranks, {wall:.1f}s, "
          f"{rec['ops']} local ops a device): per device {rec['cost']['flops']:.4e} FLOPs, "
          f"{rec['cost']['bytes_accessed']:.4e} bytes, collectives {rec['collectives']}; "
          f"arguments {m['argument_bytes'] / 1e9:.3f} GB, peak live {m['live_bytes'] / 1e9:.3f} "
          f"GB, fits 80 GB: {m['fits_hbm']}")
    print("  roofline (H100 SXM: 989 TFLOP/s bf16, 3.35 TB/s HBM, 450 GB/s NVLink; "
          f"{smi}):")
    print("  " + roofline.build_table([a]).splitlines()[-1])
    return dict(rec=rec, row=a, wall=wall)


def _launched(ops, before):
    """Launches by kernels-line entry since the counts ``before``."""
    now = main_path_launches(ops)
    return {name: now[name] - before[name] for name in now}


def phase_examples(torch, results):
    """Phase 19 (see the module docstring).  Runs each twin's ``main`` on the
    card at its full settings and checks it; times the quickstart's
    block-sparse product and adds it to ``results``.  Returns the twins'
    launches by kernels-line entry."""
    import shutil

    from repro_torch.examples import prune_style_transfer, quickstart, serve_pruned_lm
    from repro_torch.examples import train_lm_100m
    from repro_torch.kernels import bsr_matmul as kbsr
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import greedy_parity, parity_text
    from repro_torch.training.checkpoint import CheckpointManager
    from repro_torch.utils.tree import leaves_with_path

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    ops.reset_kernel_launches()
    total = {name: 0 for name in KERNELS}
    secs = {}

    def run(name, mod, argv):
        before = main_path_launches(ops)
        t0 = time.perf_counter()
        print(f"  -- {name} {' '.join(argv)}", flush=True)
        r = mod.main(argv + ["--device", "cuda"])
        secs[name] = time.perf_counter() - t0
        got = _launched(ops, before)
        for k, n in got.items():
            total[k] += n
        return r, {k: n for k, n in got.items() if n}

    # quickstart: ADMM -> PBCSR -> reorder -> the block-sparse kernel
    qs, got = run("quickstart", quickstart, [])
    fmt, x, out = qs["fmt"], qs["x"], qs["out"]
    n_launch = sum(stop > start for start, stop, _ in qs["bands"])
    check(got == {"bsr_matmul": n_launch}, f"quickstart: launches {got}, want {n_launch} bsr_matmul")
    want = kbsr.bsr_matmul_plain(x, fmt.values, fmt.block_rows)
    err = (out - want).abs().max().item()
    tol = 1e-4 * max(1.0, want.abs().max().item())
    check(err <= tol, f"quickstart: bsr_matmul vs its plain version {err} > {tol}")
    routes = [kbsr.plan_for(x, fmt.values, stop - start, count).route
              for start, stop, count in qs["bands"]]
    dense = fmt.to_dense()
    kernel = lambda: ops.bsr_matmul(x, fmt.values, fmt.block_rows, bands=qs["bands"])
    ms, plain_ms = device_ms(torch, kernel), device_ms(
        torch, lambda: kbsr.bsr_matmul_plain(x, fmt.values, fmt.block_rows), reps=5)
    lib_ms, _ = library_ms(torch, lambda: torch.matmul(x, dense))
    nb = fmt.n_blocks * fmt.bm * fmt.bn * fmt.values.element_size() + nbytes(fmt.block_rows, x, out)
    b_ms, b_by = bound(nb, 2.0 * x.shape[0] * fmt.n_blocks * fmt.bm * fmt.bn)
    results["bsr_matmul"].append(dict(
        label=f"quickstart M={x.shape[0]} 256->256 b64 f32", max_abs_err=err, ms=ms,
        plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by))
    print(f"  quickstart: primal residual {qs['primal_residual']:.4f}, {fmt.n_blocks} blocks "
          f"(pad {fmt.padded_blocks}), bands {qs['bands']}, bsr_matmul M={x.shape[0]} "
          f"{fmt.shape[0]}x{fmt.shape[1]} b{fmt.bm} route {routes} max_err {err:.3e} "
          f"(tol {tol:.1e}); ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
          f"(torch.matmul, dense) bound_ms={b_ms:.4f} ({b_by})")

    # the style-transfer app's three Table-1 variants
    st, got = run("prune_style_transfer", prune_style_transfer, [])
    calls = prune_style_transfer.REPS + 2  # the kernel plan: a warm-up, REPS timed, the outputs
    conv_n, dense_n = EXPECTED["style_transfer"][1:3]
    want_l = {"conv2d": conv_n * calls, "dense_matmul": dense_n * calls}
    check(got == want_l, f"style transfer: launches {got}, want {want_l}")
    tol = 1e-3 * max(1.0, st["reference_max"])
    check(st["kernel_vs_reference_err"] <= tol and st["agreement_max_err"] <= tol,
          f"style transfer: kernel plan vs reference plan {st['kernel_vs_reference_err']}, "
          f"vs masked dense {st['agreement_max_err']} (tol {tol})")
    # the card's busy time a frame (its kernels, not the idle between them),
    # beside the frame's wall: how far the host holds each variant back
    with torch.no_grad():
        busy = {v: device_ms(torch, lambda: fn(p, st["x"]), reps=prune_style_transfer.REPS)
                for v, (fn, p) in st["variants"].items()}
    print(f"  style transfer (base 32, 1x3x128x128): ms/frame " + ", ".join(
        f"{v} {st['ms'][v]:.3f} (paper {st['paper_ms'][v]}; device busy {busy[v]:.3f}, "
        f"idle {1 - busy[v] / st['ms'][v]:.0%})" for v in st["ms"])
        + f"; FLOPs {st['flops']['unpruned']:.4e} -> {st['flops']['pruned_compiler']:.4e} "
        f"(cut {st['flop_cut']:.2f}x); param bytes {st['param_bytes']['unpruned']} -> "
        f"{st['param_bytes']['pruned_compiler']} (cut {st['bytes_cut']:.2f}x); plan steps "
        f"{st['plan_steps']}; peak activations {st['peak_activation_bytes']} B; kernel plan vs "
        f"reference {st['kernel_vs_reference_err']:.3e}, vs masked dense "
        f"{st['agreement_max_err']:.3e} (tol {tol:.1e}); launches {got}")

    # a pruned LM through the Engine and the RequestScheduler
    sv, got = run("serve_pruned_lm", serve_pruned_lm, [])
    check(not got, f"serve_pruned_lm: port kernels launched {got} (the Engine is plain torch)")
    llm = dict(cfg=sv["cfg"], params=sv["params"], device=torch.device("cuda"))
    pars = [greedy_parity(llm, p, t) for p, t in zip(sv["prompts"], sv["tokens"])]
    pars += [greedy_parity(llm, r.prompt, r.generated) for r in sv["served"]]
    check(sv["queue_drained"] and sv["finished"] == len(sv["served"]),
          f"serve_pruned_lm: queue drained {sv['queue_drained']}, {sv['finished']} of "
          f"{len(sv['served'])} in slots finished")
    print(f"  serve_pruned_lm: {len(sv['masks'])} pruned leaves, generate "
          f"{sv['tok_per_s']:.1f} tok/s ({sv['generate_s']:.3f} s for 4 x 24 tokens), scheduler "
          f"{sv['scheduler_s']:.3f} s; {len(pars)} rows: {parity_text(pars[0])}; "
          f"all {len(pars)} exact={all(p['exact'] for p in pars)}")

    # the ~100M LM trained with ADMM, checkpoints and preemption handling
    ckpt = ROOT / "build" / "examples_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    tr, got = run("train_lm_100m", train_lm_100m, ["--prune", "--ckpt", str(ckpt)])
    check(not got, f"train_lm_100m: port kernels launched {got} (training is plain autograd)")
    ces = [h["ce"] for h in tr["history"]]
    check(all(np.isfinite(ces)) and not tr["preempted"], f"train_lm_100m: ce {ces[-5:]}")
    sp = tr["sparsity"]["pruned_global"]
    check(abs(sp - 0.5) <= 0.05, f"train_lm_100m: hard-prune sparsity {sp}")
    template = (tr["state"], tr["data_state"])
    (restored, data), step = CheckpointManager(str(ckpt)).restore_latest(template)
    want_p = dict(leaves_with_path(tr["state"].params))
    same = [torch.equal(v, want_p[k]) for k, v in leaves_with_path(restored.params)]
    check(step == len(ces) and len(same) == len(want_p) and all(same)
          and {k: int(v) for k, v in data.items()} == tr["data_state"],
          f"train_lm_100m: checkpoint step {step}, {sum(same)} of {len(want_p)} leaves equal")
    med = statistics.median(h["seconds"] for h in tr["history"][1:])
    tok_s = tr["tokens_per_step"] / med
    print(f"  train_lm_100m ({tr['cfg'].name}, {tr['n_params'] / 1e6:.1f}M params, f32, "
          f"{len(ces)} steps): ce {ces[0]:.4f} -> {ces[-1]:.4f}, hard prune at step "
          f"{tr['hard_at']} sparsity {sp:.3f}; median step {med * 1e3:.2f} ms (steps 1-), "
          f"{tok_s:.0f} tok/s, MFU {6.0 * tr['n_params'] * tok_s / PEAK_F32_FLOPS:.2%} of 67 "
          f"TFLOP/s f32; checkpoint step {step} restores torch.equal params")
    shutil.rmtree(ckpt, ignore_errors=True)
    print("  examples: " + ", ".join(f"{k} {v:.1f}s" for k, v in secs.items())
          + f"; phase {time.perf_counter() - t_phase:.1f}s")
    return total


def _to_device(tree, dev):
    """``tree`` (dicts, lists, tuples of tensors and other leaves) with every
    tensor moved by ``.to(dev)`` (a device, or a dtype: the zoo widens the
    mamba2 weights, all floating, to f32)."""
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, dev) for v in tree)
    return tree.to(dev) if hasattr(tree, "to") and hasattr(tree, "device") else tree


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # every phase before the tune phase runs untuned, whatever REPRO_TUNE /
    # REPRO_TUNE_CACHE say: tuning off, an empty cache
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops

    cache = ops.tuning_cache()
    cache.clear()
    cache.enabled = False
    cache.path = None
    cache.ops_filter = None

    t0 = time.perf_counter()

    def header(text):
        print(f"{text}  [{time.perf_counter() - t0:.0f} s]", flush=True)

    header("== device")
    smi = phase_device(torch)
    header("== build")
    phase_build()
    header("== kernels")
    results = phase_kernels(torch)
    phase_llm_kernels(torch, results)
    header(f"== apps (base={BASE}, {FRAMES} frames of {SIZE}x{SIZE}, batch {BATCH})")
    launches, apps = phase_apps(torch, np)
    header(f"== int8 apps (base={BASE}, {FRAMES} frames of {SIZE}x{SIZE}, batch {BATCH})")
    int8_launches = phase_int8(torch, np, apps)
    for name, n in int8_launches.items():
        launches[name] += n
    header(f"== profile (base={BASE}, {SIZE}x{SIZE}, batch {BATCH}, f32 + INT8 plans)")
    for name, n in phase_profile(torch, apps).items():
        launches[name] += n
    header(f"== serve async (base={BASE}, {SIZE}x{SIZE}, batch {BATCH}, f32 + INT8 plans)")
    for name, n in phase_serve_async(torch, np, apps).items():
        launches[name] += n
    header(f"== tune (base {BASE}, {SIZE}x{SIZE}, batch {BATCH})")
    for name, n in phase_tune(torch, apps).items():
        launches[name] += n
    del apps
    from repro_torch.core.pruning import Block

    header("== llm smoke (f32)")
    for name, n in phase_llm(torch, True, Block(0.5, bm=32, bn=32, balanced=False)).items():
        launches[name] += n
    header("== llm (qwen2.5-3b, full width, bf16)")
    # the paper's attention recipe (the JAX package's launch/train.py:47-48)
    for name, n in phase_llm(torch, False, Block(0.5, bm=64, bn=64)).items():
        launches[name] += n
    for arch in NEW_DECODERS:
        header(f"== llm ({arch}, full width, bf16)")
        for name, n in phase_llm(torch, False, arch=arch).items():
            launches[name] += n
    header("== serve forward (phi4-mini-3.8b, full width, bf16)")
    torch.cuda.reset_peak_memory_stats()
    phase_serve_forward(torch)
    zoo = []
    with zoo_launch_check(ops):
        header("== zoo smoke (f32)")
        phase_zoo_smoke(torch)
        for arch in ZOO_FULL:
            header(f"== zoo ({arch}, full width, bf16)")
            zoo.append(phase_zoo_full(torch, arch, smi))
    print("  zoo summary: " + "; ".join(
        f"{r['arch']} {r['tok_s']:.1f} tok/s, {r['ms_prefill']:.2f} / {r['ms_decode']:.2f} ms "
        f"prefill / decode step, peak {r['serve_peak_gb']:.3f} GB, idle "
        f"{r['profile']['idle']:.0%}"
        for r in zoo))
    header("== train smoke (f32)")
    phase_train_smoke(torch)
    header("== train (qwen2.5-3b, full width, bf16)")
    for name, n in phase_train_full(torch, smi).items():
        launches[name] += n
    header("== train profile (qwen2.5-3b, full width, bf16)")
    phase_train_profile(torch)
    tz = []
    with zoo_launch_check(ops):
        for arch, depth in TRAIN_ZOO.items():
            cut = "every layer" if depth is None else f"{depth} of {get_config(arch).n_layers} layers"
            header(f"== train zoo ({arch}, full width, bf16; {cut})")
            tz.append(phase_train_zoo(torch, arch, smi))
        header("== train remat (whisper-small, full width)")
        phase_train_remat(torch)
        torch.cuda.empty_cache()
        header(f"== mesh ({MESH_ARGS['arch']}, full width, bf16; "
               f"{torch.cuda.device_count()} card(s))")
        phase_mesh(torch, smi)
    print("  train zoo summary: " + "; ".join(
        f"{r['arch']} {r['ms_admm']:.2f} / {r['ms_fine']:.2f} ms ADMM / masked step, "
        f"{r['tok_admm']:.0f} / {r['tok_fine']:.0f} tok/s, MFU {r['mfu']['admm']:.1%} / "
        f"{r['mfu']['masked']:.1%}, peak {max(v for v in r['peak_gb'].values()):.3f} GB"
        for r in tz))
    header("== examples (the JAX package's four scripts through repro_torch.examples)")
    for name, n in phase_examples(torch, results).items():
        launches[name] += n
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")
    line = {"kernels": []}
    for name, (source, replaces) in KERNELS.items():
        head = results[name][0]  # the main-path headline case
        line["kernels"].append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in results[name]),
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shape": head["label"],
        })
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
