"""Serve one of the paper's demo apps, or a decoder LM, through the port's
plan compiler -- or a decoder LM through the forward-based ``Engine``.

    python -m repro_torch.launch.serve --graph-app super_resolution \\
        --size 256 --base 32 --frames 10 --batch-size 4
    python -m repro_torch.launch.serve --llm                  # qwen2.5-3b, bf16
    python -m repro_torch.launch.serve --llm --smoke --device cpu
    python -m repro_torch.launch.serve --async --tenants --guarded \\
        --watchdog 0.5 --graph-app coloring --size 256 --base 32 --frames 24
    python -m repro_torch.launch.serve --arch phi4-mini-3.8b --scheduler
    python -m repro_torch.launch.serve --arch granite-3-2b --smoke --device cpu
    python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b --smoke --scheduler --device cpu
    python -m repro_torch.launch.serve --async --frames 8 --metrics-dump build/m.json

Builds the app (weights from ``--seed``), prunes it with the paper's recipe
(``app_masks``), compiles it with ``PassManager`` + ``compile_plan``
(kernel backend), then serves ``--frames`` frames of ``--size`` x ``--size``
and prints the pass summary, the plan's stats and the speed:

* with ``--batch-size``: throughput mode -- the frames queue up in a
  ``PlanServer`` and run in fixed-size batches (tail batch padded);
  prints frames/s and ms/frame;
* without it: latency mode -- one frame per plan call, ``--frames`` calls;
  prints the median ms/frame.

``--quantize`` serves the INT8 plan instead: it calibrates activation
ranges on the f32 reference plan over ``--calib-batches`` random batches,
runs the ``quantize`` pass with the app's skip sets (``APP_QUANT_SKIP``,
``APP_ACT_SKIP``), compiles the result for the ``quant`` backend, and prints
a ``quantize:`` line (max error against the f32 plan on a probe batch,
weight MB before and after, the ratio, MB saved).

``--llm`` serves ``--arch`` (``--smoke``: its reduced f32 config) through
the decoder plans: ``init_lm`` draws the weights from a
``torch.Generator`` seeded with ``--seed`` on the device,
``build_decoder_graph`` lowers them to a prefill and a decode graph,
``optimize`` fuses them, ``compile_plan`` compiles both for the kernel
backend, and ``AsyncPlanServer.submit_llm`` streams ``--frames``
random prompts of 4..``--prompt-len`` tokens, ``--new-tokens`` each, with
``--batch`` sequences decoding together over a ``PagedKVCache`` of
``--kv-pages`` x ``--kv-page-size`` tokens.  It prints the plan steps, the
tokens per second, ms per decode step, the cache's peak and leaked pages
and a greedy-parity probe: the served tokens of the first prompt against
the argmax of one teacher-forced pass of the port's plain ``forward`` over
the prompt and the served tokens (a greedy loop over ``forward`` sees the
same sequence up to its first mismatch, so this is its verdict).  In f32
every token must match.  In bf16 the plan and ``forward`` round at other
places, so tokens are compared up to the first step whose top-2 logit
margin in ``forward`` is below ``PARITY_BF16_ULPS`` bf16 ulps of its
largest logit (a near-tie either path may break either way); a mismatch
before it fails.  Beside it, at every step, every served token must be
the row's best logit (f32) or within that tolerance of it (bf16).

``--async`` serves every demo app (or just ``--graph-app``) from one
``AsyncPlanServer``: each app's plan registered with its input spec, the
scheduler thread forming batches of ``--batch-size`` (default 4) under
``--flush-after`` / ``--deadline`` / ``--overload`` / ``--max-queue``, and
``--frames`` random frames submitted round-robin over the apps (and over
the ``--tenants``, each ``name[:weight[:rate[:burst]]]``; bare
``--tenants`` is ``gold:3:200,free:1:50``) through ``submit_with_retry``.
It prints requests/s and ms/frame, p50/p95/p99 latency per app and per
tenant, throttle / shed / deadline counts, a parity probe per app (the
served output against the plan run directly on that frame) and the
``health()`` lines (queue depths, watchdog timeouts, and with
``--guarded`` each plan's demotions and breakers).  ``--guarded`` compiles
the ``guarded`` backend instead of ``kernel`` (each step tries its kernel
and demotes a failure to the plain version on the same device), for
``--async`` and for ``--llm``; ``--watchdog`` fails a batch that runs
longer than that many seconds (``WatchdogTimeout``) and keeps serving.

With neither ``--llm``, ``--graph-app`` nor ``--async`` (the JAX CLI's
default path), ``--arch`` (``--smoke``: its reduced f32 config) is built
through ``get_model`` from a generator seeded with ``--seed`` on the device
and served by ``Engine``: ``--batch`` random prompts of ``--prompt-len``
tokens (numpy seed ``--seed``, drawn as the JAX CLI draws them; a VLM also
gets ``vision_tokens`` random patch embeddings a row, drawn after them),
``--new-tokens`` greedy tokens each, caches of ``max(--max-len,
vision_tokens + --prompt-len + --new-tokens)`` slots (a VLM's prefix does
not fit 128); it prints the tokens per second and the first row, and
probes greedy parity of that row against the plain ``forward`` (the
``--llm`` rule).  With ``--scheduler`` a ``RequestScheduler`` then serves
``2 x --batch`` text-only requests of random length over the ``--batch``
slots (continuous batching) and every request it returns passes the same
probe.  Every decoder-only arch serves here; whisper-small (an
encoder-decoder) exits, as in the JAX CLI.  A MoE model is served without
the probe: it drops token-slots past an expert's capacity, and that
capacity grows with the sequence, so ``forward`` over a prompt and its
continuation drops other tokens than the prefill and the one-token decode
steps did, and is no reference for them (the JAX package's is not either;
its served tokens are held to the JAX package's on the CPU by
``tests/test_torch_zoo_models.py``).  This path runs plain torch, as the
JAX package's does (``layers.linear`` without Pallas); the kernels serve
through ``--llm``, which takes the dense GQA decoders only (the others
raise the JAX lowering's ``NotImplementedError``).

``--metrics-dump PATH`` (with ``--async``, ``--llm`` or ``--graph-app``)
arms tracing for the run, snapshots the metrics registry every
``--metrics-interval`` seconds on a daemon thread, and at the end writes
the snapshots (and a final one) to ``PATH`` and the run's Chrome trace to
``PATH.trace.json``.

``--device`` defaults to ``cuda`` (raises without a GPU); ``--device cpu``
runs the kernels' plain PyTorch versions.  Unlike the JAX package's CLI,
``--frames`` counts frames (``--llm``: prompts), not batches.
"""

from __future__ import annotations

import argparse
import os
import statistics
import threading
import time

import numpy as np
import torch

from ..configs import ARCH_IDS, get_config, smoke_config
from ..convert import resolve_device
from ..core.graph import PassContext, PassManager, compile_plan
from ..kernels.ref import bf16_ulp
from ..models.cnn import APP_ACT_SKIP, APP_INPUT_CHANNELS, APP_QUANT_SKIP, APPS, app_masks
from ..models.transformer import model_dtype as lm_dtype
from ..quant import calibrate_plan
from ..serving.engine import PlanServer
from ..utils.fileio import atomic_write_json

__all__ = ["main", "serve_graph_app", "serve_async", "serve_llm", "serve_forward",
           "build_llm", "serve_llm_traffic", "greedy_parity", "parity_rule", "llm_prompts"]

#: the bf16 near-tie threshold of the greedy-parity probe, in bf16 ulps of
#: the largest logit (see the module doc)
PARITY_BF16_ULPS = 8


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _MetricsDump:
    """``--metrics-dump`` session: arms tracing for the duration, snapshots
    the metrics registry every ``interval`` seconds on a daemon thread, and
    on exit writes the snapshot series (plus a final one) to ``path`` and
    the session's Chrome trace next to it (``<path>.trace.json``)."""

    def __init__(self, path: str, interval: float):
        self.path = path
        self.interval = interval
        self._snaps: list = []
        self._stop = threading.Event()
        self._thread = None

    def _loop(self) -> None:
        from ..obs import metrics

        while not self._stop.wait(self.interval):
            self._snaps.append({"t": time.time(), "metrics": metrics.registry().snapshot()})

    def __enter__(self) -> "_MetricsDump":
        from ..obs import trace

        trace.start_tracing()
        self._thread = threading.Thread(target=self._loop, name="metrics-dump", daemon=True)
        self._thread.start()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        from ..obs import metrics, trace

        self._stop.set()
        self._thread.join()
        self._snaps.append({"t": time.time(), "metrics": metrics.registry().snapshot()})
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        # crash-safe (utils.fileio): a killed server never leaves a truncated
        # snapshot JSON
        atomic_write_json(self.path, {"interval_s": self.interval, "snapshots": self._snaps},
                          indent=1, prefix=".metrics-")
        buf = trace.stop_tracing()
        trace_path = buf.save(self.path + ".trace.json")
        print(f"metrics: {len(self._snaps)} snapshots -> {os.path.abspath(self.path)}")
        print(f"trace: {len(buf.events)} events -> {trace_path} "
              f"(load in Perfetto / chrome://tracing)")


def serve_graph_app(args) -> dict:
    """Compile ``args.graph_app`` through the full pipeline and serve frames
    through the plan; returns the numbers it prints."""
    dev = resolve_device(args.device)
    if dev.type == "cuda":  # the plan tolerances assume true f32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    g = APPS[args.graph_app](torch.Generator().manual_seed(args.seed), base=args.base, device=dev)
    masks, structures = app_masks(g, args.graph_app, sparsity=args.sparsity)
    ctx = PassContext(masks=masks, structures=structures)
    pm = PassManager()
    go = pm.run(g, ctx)
    print(pm.summary(ctx))

    c_in = APP_INPUT_CHANNELS[args.graph_app]
    batch = args.batch_size or 1
    shape = (batch, c_in, args.size, args.size)
    rng = np.random.default_rng(args.seed)
    backend = "kernel"
    if args.quantize:
        go, backend = quantize_app(args, go, dev, shape, rng), "quant"
    plan = compile_plan(go, backend=backend, device=dev)
    mem = plan.memory_estimate(shape)
    print(
        f"plan: backend={backend} device={dev} steps={len(plan.steps)} "
        f"peak_act@batch{batch}={mem['peak_activation_bytes'] / 1e6:.2f}MB "
        f"params={mem['param_bytes'] / 1e6:.2f}MB"
    )
    frames = torch.from_numpy(
        rng.standard_normal((args.frames, c_in, args.size, args.size)).astype(np.float32)
    ).to(dev)
    report = {"app": args.graph_app, "device": str(dev), "steps": len(plan.steps),
              "backend": backend}

    if args.batch_size is not None:
        server = PlanServer(plan, go.params, args.batch_size, name=args.graph_app)
        server.submit(frames[0])  # warm-up: allocator and first launches
        server.flush()
        _sync(dev)
        server.stats = {k: 0 for k in server.stats}
        t0 = time.perf_counter()
        for f in frames:
            server.submit(f)
        server.flush()
        _sync(dev)
        dt = time.perf_counter() - t0
        s = server.stats
        report.update(frames=s["frames"], seconds=dt, frames_per_s=s["frames"] / dt,
                      ms_per_frame=dt / s["frames"] * 1e3)
        print(
            f"{args.graph_app}: {s['frames']} frames in {dt:.4f}s "
            f"({report['frames_per_s']:.1f} frames/s, {report['ms_per_frame']:.3f} ms/frame) "
            f"over {s['batches']} batches of {args.batch_size} ({s['padded_frames']} padded)"
        )
        return report

    x = frames[:1]
    plan(go.params, x)  # warm-up
    _sync(dev)
    times = []
    for i in range(args.frames):
        x = frames[i : i + 1]
        t0 = time.perf_counter()
        plan(go.params, x)
        _sync(dev)
        times.append(time.perf_counter() - t0)
    ms = statistics.median(times) * 1e3
    report.update(ms_per_frame=ms)
    print(f"{args.graph_app}: {ms:.3f} ms/frame over {args.frames} frames "
          f"(1x{args.size}x{args.size}, sparsity {args.sparsity})")
    return report


def _parse_tenants(spec: str):
    """Parse ``--tenants`` specs: comma-separated
    ``name[:weight[:rate[:burst]]]`` (weight = fair share of batch slots,
    rate/burst = token-bucket quota in requests/s)."""
    out = []
    for part in spec.split(","):
        bits = [b.strip() for b in part.strip().split(":")]
        if not bits or not bits[0]:
            raise SystemExit(f"--tenants: empty tenant name in {spec!r}")
        out.append((
            bits[0],
            float(bits[1]) if len(bits) > 1 else 1.0,
            float(bits[2]) if len(bits) > 2 else None,
            float(bits[3]) if len(bits) > 3 else None,
        ))
    return out


def _pcts(lats) -> str:
    return (f"p50={np.percentile(lats, 50) * 1e3:.2f}ms "
            f"p95={np.percentile(lats, 95) * 1e3:.2f}ms "
            f"p99={np.percentile(lats, 99) * 1e3:.2f}ms")


def serve_async(args) -> dict:
    """One ``AsyncPlanServer`` hosting every demo app (or just
    ``--graph-app``): compile each app's plan, start the scheduler thread,
    drive mixed traffic with per-request deadlines, and report throughput,
    latency percentiles, deadline-miss and padding stats and a per-app
    parity probe against direct plan execution; with ``--tenants`` the
    traffic is spread round-robin over the tenants and the report breaks
    latency, throttling and ladder state out per tenant.  Returns the
    numbers it prints."""
    from ..serving import AsyncPlanServer, submit_with_retry

    if args.quantize:
        raise SystemExit("--async serves f32 plans only (for INT8 serving use --graph-app "
                         "<app> --quantize); refusing to silently ignore --quantize")
    dev = resolve_device(args.device)
    if dev.type == "cuda":  # the plan tolerances assume true f32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    apps = [args.graph_app] if args.graph_app else list(APPS)
    backend = "guarded" if args.guarded else "kernel"
    batch_size = args.batch_size or 4
    rng = np.random.default_rng(args.seed)
    server = AsyncPlanServer(flush_after=args.flush_after, max_queue=args.max_queue,
                             overload=args.overload, watchdog=args.watchdog)
    tenant_specs = _parse_tenants(args.tenants) if args.tenants else []
    tnames = [t[0] for t in tenant_specs]
    for name, weight, rate, burst in tenant_specs:
        server.add_tenant(name, weight=weight, rate=rate, burst=burst)
        quota = f"{rate}/s" if rate is not None else "unlimited"
        print(f"async: tenant {name}: weight={weight} quota={quota}")
    plans, shapes = {}, {}
    for app in apps:
        g = APPS[app](torch.Generator().manual_seed(args.seed), base=args.base, device=dev)
        masks, structures = app_masks(g, app, sparsity=args.sparsity)
        go = PassManager().run(g, PassContext(masks=masks, structures=structures))
        plan = compile_plan(go, backend=backend, device=dev)
        plans[app] = (plan, go.params)
        shapes[app] = (APP_INPUT_CHANNELS[app], args.size, args.size)
        # explicit input spec: a malformed frame fails at submit(), never
        # inside the macro-batch it would have joined
        server.add_plan(app, plan, go.params, batch_size,
                        input_spec=[(shapes[app], torch.float32)])
        print(f"async: {app}: backend={backend} device={dev} steps={len(plan.steps)} "
              f"batch_size={batch_size}")

    with server:
        server.start()
        # warm each app (allocator, first launches) before timing; the
        # counters are read after it so the report covers the traffic only
        for app in apps:
            server.submit(app, torch.zeros(shapes[app], device=dev)).result()
        warm = server.stats
        frames = [torch.from_numpy(rng.standard_normal(shapes[apps[i % len(apps)]])
                                   .astype(np.float32)).to(dev) for i in range(args.frames)]
        handles, probes = [], {}
        t0 = time.perf_counter()
        for i, x in enumerate(frames):
            app = apps[i % len(apps)]
            tenant = tnames[i % len(tnames)] if tnames else None
            # with quotas in play, ride out QuotaExceededError via the
            # shared jittered backoff instead of failing the demo
            h = submit_with_retry(server, app, x, priority=i % 2, deadline=args.deadline,
                                  tenant=tenant)
            handles.append(h)
            probes.setdefault(app, (x, h))  # first frame per app: parity probe
        for h in handles:
            h.result()
        dt = time.perf_counter() - t0
        for app, (x, h) in probes.items():
            plan, params = plans[app]
            with torch.no_grad():
                want = plan(params, x[None])[0]
            err = float((h.result() - want).abs().max())
            tol = 1e-5 * max(1.0, float(want.abs().max()))
            if err > tol:  # the async path == direct execution
                raise AssertionError(f"async {app}: served output differs from the plan's "
                                     f"by {err} > {tol}")
        s = server.stats
        n = len(handles)
        report = dict(requests=n, seconds=dt, ms_per_frame=dt / n * 1e3, backend=backend,
                      device=str(dev), stats=s)
        print(f"async: {n} requests over {len(apps)} plans in {dt:.3f}s "
              f"({n / dt:.1f} req/s, {dt / n * 1e3:.3f} ms/frame), "
              f"{s['batches'] - warm['batches']} batches "
              f"({s['padded_frames'] - warm['padded_frames']} padded frames, "
              f"{s['deadline_flushes'] - warm['deadline_flushes']} deadline flushes, "
              f"{s['deadline_misses'] - warm['deadline_misses']} deadline misses, parity ok)")
        for app in apps:
            # over the traffic handles only, not the warm-up request
            lats = np.asarray([h.latency for h in handles if h.plan == app])
            if not lats.size:  # fewer requests than apps: no traffic here
                print(f"async: {app}: no traffic")
                continue
            print(f"async: {app}: {_pcts(lats)} over {lats.size} requests")
        for name in tnames:
            lats = np.asarray([h.latency for h in handles if h.tenant == name])
            st = s["per_tenant"][name]
            pct = f"{_pcts(lats)} over {lats.size} requests, " if lats.size else "no traffic, "
            print(f"async: tenant {name}: {pct}throttled={st['throttled']} "
                  f"ladder_shed={st['ladder_shed']} deadline_misses={st['deadline_misses']}")
        # liveness/degradation snapshot: what an external monitor scrapes
        health = server.health()
        print(f"health: running={health['running']} inflight={health['inflight']} "
              f"pending={health['pending']} tick_errors={health['tick_errors']} "
              f"watchdog={health['watchdog']}")
        for app, p in health["plans"].items():
            st = p["stats"]
            line = (f"health: {app}: queue_depth={p['queue_depth']} "
                    f"queue_peak={p['queue_peak']} bad_frames={st['bad_frames']} "
                    f"watchdog_timeouts={st['watchdog_timeouts']} "
                    f"rejected={st['rejected']} shed={st['shed']}")
            if "guard" in p:
                gc = p["guard"]["counters"]
                brs = ", ".join(f"{k}={b['state']}" for k, b in p["guard"]["breakers"].items())
                line += (f" | guard: primary_ok={gc['primary_ok']} "
                         f"fallbacks={gc['fallbacks']} breakers=[{brs or 'none yet'}]")
            print(line)
        for name in tnames:
            th = health["tenants"][name]
            print(f"health: tenant {name}: level={th['level_name']} "
                  f"weight={th['weight']} tokens={th['tokens']}")
        report["health"] = health
    return report


def quantize_app(args, go, dev, shape, rng):
    """Calibrate ``go`` on its f32 reference plan, run the ``quantize`` pass
    with the app's skip sets and print the ``quantize:`` line; returns the
    quantized graph."""
    plan_f32 = compile_plan(go, backend="reference", device=dev)

    def batch():
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)

    table = calibrate_plan(plan_f32, go.params, [batch() for _ in range(args.calib_batches)])
    qctx = PassContext(calibration=table, quant_skip=APP_QUANT_SKIP[args.graph_app],
                       act_quant_skip=APP_ACT_SKIP[args.graph_app])
    gq = PassManager(("quantize",)).run(go, qctx)
    plan_q = compile_plan(gq, backend="quant", device=dev)
    probe = batch()
    with torch.no_grad():
        err = float((plan_q(gq.params, probe) - plan_f32(go.params, probe)).abs().max())
    mem_f, mem_q = plan_f32.memory_estimate(shape), plan_q.memory_estimate(shape)
    print(
        f"quantize: calibrated {table.batches} batches over {len(table.ranges)} values; "
        f"max_abs_err={err:.2e} weights {mem_f['param_bytes'] / 1e6:.2f}MB -> "
        f"{mem_q['param_bytes'] / 1e6:.2f}MB "
        f"({mem_f['param_bytes'] / mem_q['param_bytes']:.2f}x, "
        f"{mem_q['weight_bytes_saved'] / 1e6:.2f}MB saved)"
    )
    return gq


def build_llm(args, dev: torch.device) -> dict:
    """``init_lm`` on ``dev`` from a generator seeded with ``args.seed``,
    the optimized prefill / decode graphs and their plans (the ``guarded``
    backend with ``args.guarded``, else ``kernel``)."""
    from ..core.graph import compile_plan
    from ..core.graph.passes import optimize
    from ..models.transformer import init_lm
    from ..models.transformer_graph import build_decoder_graph, check_config

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    check_config(cfg)  # before drawing a model the lowering refuses
    params = init_lm(torch.Generator(device=dev).manual_seed(args.seed), cfg)
    graphs = {ph: optimize(build_decoder_graph(params, cfg, phase=ph))
              for ph in ("prefill", "decode")}
    backend = "guarded" if args.guarded else "kernel"
    plans = {ph: compile_plan(g, backend=backend, device=dev) for ph, g in graphs.items()}
    return dict(cfg=cfg, params=params, graphs=graphs, plans=plans, device=dev)


def llm_prompts(args, cfg) -> list:
    """``args.frames`` prompts of 4..``args.prompt_len`` random tokens (numpy
    seed ``args.seed``), as the JAX package's CLI draws them."""
    rng = np.random.default_rng(args.seed)
    return [
        rng.integers(0, cfg.vocab, size=int(rng.integers(4, args.prompt_len + 1))).astype(np.int32)
        for _ in range(max(1, args.frames))
    ]


def serve_llm_traffic(llm: dict, prompts, args) -> dict:
    """Serve ``prompts`` through a fresh ``AsyncPlanServer`` (scheduler
    thread) over a fresh ``PagedKVCache``; returns the handles, the wall
    seconds, the model's stats and the cache's occupancy (checked for
    invariants)."""
    from ..models.transformer_graph import decoder_cache_spec
    from ..serving import AsyncPlanServer, PagedKVCache

    cache = PagedKVCache(num_pages=args.kv_pages, page_size=args.kv_page_size,
                         **decoder_cache_spec(llm["cfg"]))
    server = AsyncPlanServer(max_queue=args.max_queue)
    server.add_llm("lm", prefill=llm["plans"]["prefill"], decode=llm["plans"]["decode"],
                   cache=cache, max_batch=args.batch)
    with server:
        server.start()
        t0 = time.perf_counter()
        handles = [server.submit_llm("lm", p, max_new_tokens=args.new_tokens) for p in prompts]
        for h in handles:
            h.result()
        dt = time.perf_counter() - t0
    cache.check_invariants()
    return dict(handles=handles, seconds=dt, stats=server.stats["per_llm"]["lm"],
                occupancy=cache.occupancy())


def _bf16_tol(top: float) -> float:
    """``PARITY_BF16_ULPS`` bf16 ulps at magnitude ``top``."""
    return PARITY_BF16_ULPS * bf16_ulp(top)


def greedy_parity(llm: dict, prompt, got, patch_embeds=None) -> dict:
    """The served tokens ``got`` of ``prompt`` against one teacher-forced
    ``forward`` over ``prompt + got[:-1]`` (pad classes excluded), by
    :func:`parity_rule`.  ``patch_embeds [1, P, D]`` is a VLM prompt's
    prefix.  Returns what it compared; raises on a mismatch."""
    from ..models.transformer import forward

    cfg, params, dev = llm["cfg"], llm["params"], llm["device"]
    forced = [int(t) for t in prompt] + [int(t) for t in got[:-1]]
    with torch.no_grad():
        rows = forward(params, cfg, torch.tensor([forced], dtype=torch.int32, device=dev),
                       patch_embeds=patch_embeds)[0]
    return parity_rule(rows[0, len(prompt) - 1:, :cfg.vocab], got,
                       bf16=cfg.dtype == "bfloat16")


def parity_rule(rows: torch.Tensor, got, bf16: bool) -> dict:
    """Served tokens ``got`` against teacher-forced logits ``rows [n, V]``
    (row i scores what follows the prompt and ``got[:i]``):

    * the tokens equal the rows' argmax -- every one in f32; in bf16 up to
      the first row whose top-2 margin is below the bf16 tolerance (module
      doc).  Up to its first mismatch a free-running greedy loop sees the
      same sequence, so this is that loop's verdict;
    * every served token's logit is its row's maximum (f32), or within the
      bf16 tolerance of it (bf16).

    Returns what it compared; raises on a mismatch."""
    got = [int(t) for t in got]
    rows = rows.float()
    top2 = torch.topk(rows, 2, dim=-1).values
    best = top2[:, 0]
    picked = rows[torch.arange(len(got), device=rows.device),
                  torch.tensor(got, device=rows.device)]
    want = rows.argmax(-1).cpu().tolist()
    margins = (best - top2[:, 1]).cpu().tolist()
    gaps = (best - picked).cpu().tolist()
    tops = rows.abs().max(dim=-1).values.cpu().tolist()
    compared, tie = len(got), None
    if bf16:
        for i, (margin, top) in enumerate(zip(margins, tops)):
            if margin < _bf16_tol(top):
                compared, tie = i, (margin, _bf16_tol(top))
                break
    if got[:compared] != want[:compared]:
        raise AssertionError(f"greedy parity: served {got} vs forward {want} "
                             f"(compared the first {compared})")
    for i, (gap, top) in enumerate(zip(gaps, tops)):
        if gap > (_bf16_tol(top) if bf16 else 0.0):
            raise AssertionError(f"greedy parity: served token {got[i]} at step {i} is "
                                 f"{gap} below forward's best logit")
    return dict(compared=compared, total=len(got), exact=got == want, near_tie=tie,
                min_margin=min(margins) if margins else None,
                max_forced_gap=max(gaps) if gaps else 0.0)


def parity_text(par: dict) -> str:
    """The line a passed :func:`greedy_parity` prints."""
    how = "every token" if par["near_tie"] is None else (
        f"up to a near-tie at step {par['compared']} (margin {par['near_tie'][0]:.4f} < "
        f"{par['near_tie'][1]:.4f})")
    return (f"greedy parity ok ({par['compared']}/{par['total']} tokens match the argmax "
            f"of the teacher-forced plain forward, {how}; exact={par['exact']}; every served "
            f"token within {par['max_forced_gap']:.4f} of forward's best logit)")


def serve_llm(args) -> dict:
    """The ``--llm`` path: build, serve once to warm up, serve the timed run,
    probe greedy parity; returns the numbers it prints."""
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    llm = build_llm(args, dev)
    cfg, plans = llm["cfg"], llm["plans"]
    print(f"llm: {args.arch}{' (smoke)' if args.smoke else ''} {cfg.dtype}: "
          f"backend={plans['decode'].backend} device={dev} "
          f"prefill_steps={len(plans['prefill'].steps)} "
          f"decode_steps={len(plans['decode'].steps)}")
    prompts = llm_prompts(args, cfg)
    serve_llm_traffic(llm, prompts, args)  # warm-up: allocator, first launches
    run = serve_llm_traffic(llm, prompts, args)
    st, occ, dt = run["stats"], run["occupancy"], run["seconds"]
    toks = sum(len(h.result()) for h in run["handles"])
    ms_decode = st["decode_seconds"] / max(st["decode_batches"], 1) * 1e3
    print(f"llm: {len(prompts)} sequences, {toks} tokens in {dt:.3f}s ({toks / dt:.1f} tok/s) -- "
          f"{st['prefill_batches']} prefill + {st['decode_batches']} decode batches, "
          f"{st['decode_tokens']} batched decode tokens, {ms_decode:.2f} ms/decode step, "
          f"failed={st['failed']}")
    print(f"llm: cache {occ['num_pages']}x{occ['page_size']} pages: "
          f"peak_used={occ['peak_used']} leaked={occ['used_pages']}")
    got = [int(t) for t in run["handles"][0].result()]
    par = greedy_parity(llm, prompts[0], got)
    print(f"llm: {parity_text(par)}")
    return dict(tokens=toks, seconds=dt, tok_per_s=toks / dt, ms_per_decode_step=ms_decode,
                stats=st, occupancy=occ, parity=par, steps={ph: len(p.steps) for ph, p in
                                                             plans.items()})


def serve_forward(args) -> dict:
    """The default path: ``get_model`` + ``Engine`` (+ ``RequestScheduler``
    with ``--scheduler``), as the JAX CLI's; returns the numbers it
    prints."""
    from ..models import get_model
    from ..serving.engine import Engine, Request, RequestScheduler

    dev = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.is_encdec:
        raise SystemExit(f"serve: {args.arch} is an encoder-decoder; the Engine serves "
                         "decoder-only models (run it through repro_torch.models.encdec)")
    model = get_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    # a VLM's patches come first: the caches hold them, the prompt and the reply
    max_len = max(args.max_len, cfg.vision_tokens + args.prompt_len + args.new_tokens)
    engine = Engine(model, params, batch_size=args.batch, max_len=max_len)
    llm = dict(cfg=cfg, params=params, device=dev)  # what greedy_parity reads
    probe = cfg.moe is None  # see the module doc
    print(f"forward: {args.arch}{' (smoke)' if args.smoke else ''} {cfg.dtype} device={dev} "
          f"batch={args.batch} max_len={max_len}")

    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)).astype(np.int32)
    patches = None
    if cfg.vision_tokens:
        patches = torch.from_numpy(rng.standard_normal(
            (args.batch, cfg.vision_tokens, cfg.d_model)).astype(np.float32)).to(
            dev, lm_dtype(cfg))
    t0 = time.perf_counter()
    result = engine.generate(torch.from_numpy(prompts), args.new_tokens, patch_embeds=patches)
    dt = time.perf_counter() - t0  # generate returns host arrays: the card is done
    n_tok = args.batch * args.new_tokens
    print(f"generated {result.tokens.shape} in {dt:.2f}s ({n_tok / dt:.1f} tok/s)")
    print("first row:", result.tokens[0].tolist())
    par = None
    if probe:
        par = greedy_parity(llm, prompts[0], result.tokens[0],
                            patch_embeds=None if patches is None else patches[:1])
        print(f"forward: {parity_text(par)}")
    else:
        print("forward: no greedy-parity probe for a MoE model (forward over a longer "
              "sequence drops other token-slots)")
    report = dict(tokens=result.tokens, seconds=dt, tok_per_s=n_tok / dt, parity=par)

    if args.scheduler:
        reqs = []
        for rid in range(args.batch * 2):  # 2x oversubscribed queue
            plen = int(rng.integers(4, args.prompt_len))
            reqs.append((rid, rng.integers(0, cfg.vocab, plen).astype(np.int32),
                         int(rng.integers(3, args.new_tokens))))

        sched = RequestScheduler(engine)
        for rid, prompt, max_new in reqs:
            sched.submit(Request(rid=rid, prompt=prompt, max_new=max_new))
        t0 = time.perf_counter()
        done = sched.run()
        dt = time.perf_counter() - t0
        for req in done if probe else ():
            greedy_parity(llm, req.prompt, req.generated)
        print(f"scheduler: completed {sum(r.done for r in done)} requests "
              f"(continuous batching over {args.batch} slots) in {dt:.2f}s"
              + (f"; greedy parity ok for the {len(done)} requests still in their slots"
                 if probe else ""))
        report["scheduler"] = done
    return report


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--graph-app", choices=sorted(APPS),
                    help="the demo app to compile and serve")
    ap.add_argument("--llm", action="store_true",
                    help="serve --arch through the decoder plans (prefill + decode) with a "
                         "paged KV-cache and token-level continuous batching")
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2.5-3b")
    ap.add_argument("--smoke", action="store_true", help="llm: the arch's reduced f32 config")
    ap.add_argument("--batch", type=int, default=4,
                    help="llm: sequences decoding together (AsyncPlanServer max_batch)")
    ap.add_argument("--prompt-len", type=int, default=16, help="llm: longest random prompt")
    ap.add_argument("--new-tokens", type=int, default=12, help="llm: tokens per sequence")
    ap.add_argument("--max-len", type=int, default=128,
                    help="default path: KV-cache slots a row of the Engine (raised to "
                         "vision_tokens + --prompt-len + --new-tokens where that is more)")
    ap.add_argument("--scheduler", action="store_true",
                    help="default path: continuous batching demo (RequestScheduler over "
                         "2 x --batch requests)")
    ap.add_argument("--kv-pages", type=int, default=64,
                    help="llm: total pages in the paged KV-cache pool")
    ap.add_argument("--kv-page-size", type=int, default=16, help="llm: tokens per KV page")
    ap.add_argument("--max-queue", type=int, default=1024,
                    help="llm / async: bounded admission queue (per plan; llm: waiting + "
                         "active sequences)")
    ap.add_argument("--guarded", action="store_true",
                    help="llm / async: serve guarded plans (per-step kernel -> plain-version "
                         "demotion with circuit breakers and NaN/Inf guards)")
    ap.add_argument("--async", dest="async_serve", action="store_true",
                    help="one AsyncPlanServer hosts every demo app (or just --graph-app): a "
                         "scheduler thread forms batches from the admission queues; "
                         "per-request latency, deadline and tenant stats")
    ap.add_argument("--flush-after", type=float, default=0.02,
                    help="async: seconds the oldest queued request may wait for batch fill")
    ap.add_argument("--deadline", type=float, default=None,
                    help="async: per-request latency budget in seconds (late completions "
                         "count as deadline misses)")
    ap.add_argument("--overload", choices=["reject", "shed"], default="reject",
                    help="async: backpressure policy when a queue is full")
    ap.add_argument("--tenants", nargs="?", default=None, const="gold:3:200,free:1:50",
                    help="async: serve traffic as tenants, comma-separated "
                         "name[:weight[:rate[:burst]]] (weight = fair share of batch slots, "
                         "rate/burst = token-bucket quota in req/s); bare --tenants is "
                         "gold:3:200,free:1:50")
    ap.add_argument("--watchdog", type=float, default=None,
                    help="async: per-batch execution deadline in seconds; a batch that "
                         "blows it fails only its own handles (WatchdogTimeout)")

    ap.add_argument("--size", type=int, default=64, help="frame height and width")
    ap.add_argument("--base", type=int, default=16, help="channel width of the app")
    ap.add_argument("--frames", type=int, default=3, help="frames to serve")
    ap.add_argument("--batch-size", type=int, default=None,
                    help="throughput mode: serve through PlanServer in batches of this size "
                         "(async: the plans' batch size, default 4)")
    ap.add_argument("--sparsity", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a GPU) or cpu")
    ap.add_argument("--quantize", action="store_true",
                    help="serve the INT8 plan (calibrate, quantize, quant backend)")
    ap.add_argument("--calib-batches", type=int, default=2,
                    help="random batches to calibrate activation ranges on (--quantize)")
    ap.add_argument("--metrics-dump", default=None,
                    help="write periodic metrics-registry snapshots to this JSON path and the "
                         "run's Chrome trace to <path>.trace.json (tracing is armed for the "
                         "run; --async, --llm and --graph-app)")
    ap.add_argument("--metrics-interval", type=float, default=0.5,
                    help="seconds between --metrics-dump registry snapshots")
    return ap


def _serve(args) -> dict:
    if args.async_serve:
        return serve_async(args)
    if args.llm:
        return serve_llm(args)
    if args.graph_app:
        return serve_graph_app(args)
    return serve_forward(args)


def main(argv=None) -> dict:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.async_serve and args.llm:
        ap.error("--async serves the demo apps; --llm has its own server")
    if args.llm and args.graph_app is not None:
        ap.error("give at most one of --graph-app and --llm (or --async)")
    if args.metrics_dump and (args.async_serve or args.graph_app or args.llm):
        with _MetricsDump(args.metrics_dump, args.metrics_interval):
            return _serve(args)
    return _serve(args)


if __name__ == "__main__":
    main()
