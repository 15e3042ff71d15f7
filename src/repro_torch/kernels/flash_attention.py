"""Flash attention (forward, GQA, optional valid-prefix lengths): CUDA kernel +
plain version.

Replaces the TPU kernels ``repro/kernels/flash_attention.py:
flash_attention_kernel`` and ``_flash_attention_kernel_len`` (wrapper
``flash_attention``) with one CUDA kernel (``csrc/flash_attention.cu``)
whose lengths pointer may be null.

``flash_attention(q, k, v, kv_lengths=None, causal=..., scale=None)``:
``q [B, H, Sq, d]``, ``k`` / ``v [B, G, Skv, d]`` with ``H % G == 0`` --
query head ``h`` reads KV group ``h // (H // G)``, the grouping of the
executor's ``_attn_heads`` (``G == H`` is plain multi-head attention) --
and ``kv_lengths [B]`` int32.  ``d`` is 32, 64 or 128 on the card.  Any
strides over (batch, head, seq) are taken as they are, with a unit stride
over ``d``, so the executor's head-split views need no copy; the output is
``[B, H, Sq, d]`` in q's type, laid out ``[B, Sq, H, d]`` in memory (the
executor's merge of the heads is then a view).  q and k/v may differ in
type: (f32, f32), (bf16, bf16) and (bf16, f32) -- the decode merge hands
bf16 queries against the f32 cache span -- and the kernel computes in f32
either way.  Masked scores are ``-1e30`` (causal keeps ``col <= row``,
lengths keep ``col < length``), exactly as the TPU kernel masks.

The kernel (``csrc/flash_attention.cu``) has three bodies; :func:`plan`
picks one from the shape alone (never from the lengths on the device, so
no host sync):

* ``split`` -- split-KV, ``Sq <= 8`` (decode) and every type pair: one CTA
  per (batch row, KV group, key split) stages its chunk of K / V once with
  16-byte ``cp.async`` copies, scores all ``H / G`` query heads of the
  group (x ``Sq`` rows) against it, so K / V are read once per group, and
  writes ``(m, l, acc)`` partials to an f32 workspace that a second small
  kernel merges in split order (one launch when there is one split).  The
  split count is fixed by ``(B, G, Skv)`` and fills the H100's 132 SMs at
  ``B = 1`` too;
* ``tensor_core`` -- bf16 q and k/v with ``Sq > 8`` (prefill): 64 query
  rows a CTA, the rows of a group's heads stacked so that K / V tiles are
  shared, ``ldmatrix`` + ``mma.sync`` m16n8k16 for ``Q K^T`` and for
  ``P V`` (P kept in f32 as two bf16 halves, hi and lo), K / V tiles
  through a ``cp.async`` double buffer, tiles past every row's length or
  above the causal diagonal skipped;
* ``simt`` -- the rest (f32 prefill, bf16 q against f32 k/v with
  ``Sq > 8``, operands not 16-byte aligned): a warp a query row on the
  CUDA cores.

What bounds it on an H100: at decode the K / V bytes of the span (read
once per KV group); at prefill the latency of a short chain of tensor-core
steps.  Routing: a CPU tensor takes :func:`flash_attention_plain` (which
repeats each KV group to its query heads, as ``_attn_heads`` does), a CUDA
tensor launches the kernel or raises.  ``launches`` counts calls that
launched the kernel, ``route_launches`` splits them by route.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import _build
from .ref import flash_attention_ref

__all__ = ["flash_attention", "flash_attention_plain", "plan", "plan_for", "FlashPlan",
           "ROUTES", "TYPES"]

#: kernel launches made by :func:`flash_attention` (CUDA route only)
launches = 0
#: the same launches by route (a split launch with a combine counts once)
route_launches = {"simt": 0, "tensor_core": 0, "split": 0}

#: the kernel's bodies, by the code its C entry takes (csrc/flash_attention.cu)
ROUTES = {"simt": 0, "tensor_core": 1, "split": 2}
#: the (q, k/v) element types the kernel takes, by the code its C entry takes
TYPES = {
    (torch.float32, torch.float32): 0,
    (torch.bfloat16, torch.bfloat16): 1,
    (torch.bfloat16, torch.float32): 2,
}
_HEAD_DIMS = (32, 64, 128)

#: the split route: the most query rows a launch may have (decode is one),
#: the most rows of a KV group a CTA scores (H / G heads x Sq rows;
#: csrc/flash_attention.cu split_kv::MAX_ROWS), the CTAs a launch aims for,
#: and the fewest / most keys of a split, a multiple of ``SPLIT_ALIGN`` (the
#: C entry takes up to split_kv::MAX_CHUNK).  One CTA for every two of an
#: H100's 132 SMs, at most 64 keys a split: on qwen2.5-3b's decode (B3
#: H16/G2, span 1024) 16 splits of 64 keys ran 0.0112 ms against 0.0121 for
#: 22 of 48 (132 CTAs) and 0.0124 for 11 of 96 (at most 128 keys), and at
#: B = 1 32 splits of 32 keys 0.0108 against 0.0144 for 64 of 16 -- each
#: CTA pays for staging q and three barriers, and the combine reads every
#: split's partial (tools/bsr_conv_bench.py --flash-target / --flash-chunk)
SPLIT_MAX_SQ, SPLIT_MAX_ROWS, SPLIT_TARGET = 8, 64, 66
SPLIT_MIN_CHUNK, SPLIT_MAX_CHUNK, SPLIT_ALIGN = 16, 64, 16
#: the tensor-core route's stacked query rows a CTA and keys a K / V tile
#: (csrc/flash_attention.cu tc::BM, KT); the SIMT route's rows a CTA
TC_ROWS, TC_KEYS, SIMT_ROWS = 64, 64, 4


class FlashPlan(NamedTuple):
    """One launch of the kernel: the body, the key splits of each (batch
    row, KV group) -- ``nsplit`` splits of ``chunk`` keys, the last one
    shorter; one split of all keys outside the split route -- and the
    query rows a CTA covers."""

    route: str
    nsplit: int
    chunk: int
    rows: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _split(b: int, g: int, skv: int):
    """``(nsplit, chunk)`` of the split route, fixed by ``(B, G, Skv)``: about
    ``SPLIT_TARGET`` CTAs over the ``B * G`` groups, each split at least
    ``SPLIT_MIN_CHUNK`` keys (or all of them) and at most
    ``SPLIT_MAX_CHUNK``, a multiple of ``SPLIT_ALIGN``."""
    if skv <= 0:
        return 1, 0
    want = min(_cdiv(SPLIT_TARGET, max(1, b * g)), _cdiv(skv, SPLIT_MIN_CHUNK))
    want = max(want, _cdiv(skv, SPLIT_MAX_CHUNK), 1)
    chunk = _cdiv(_cdiv(skv, want), SPLIT_ALIGN) * SPLIT_ALIGN
    return _cdiv(skv, chunk), chunk


def plan(b: int, h: int, g: int, sq: int, skv: int, d: int, types: int, causal: bool,
         aligned: bool = True) -> FlashPlan:
    """The route and split of a launch, from its shape alone: ``q [b, h, sq,
    d]``, ``k / v [b, g, skv, d]``, ``types`` a code of :data:`TYPES`;
    ``aligned``: q, k and v rows start on 16-byte boundaries (the split and
    tensor-core bodies' copies).  ``causal`` moves neither the route nor
    the split: a split above a row's diagonal leaves a partial the combine
    ignores.

    ``sq <= SPLIT_MAX_SQ`` with at most ``SPLIT_MAX_ROWS`` rows of a group
    (``h // g * sq``) takes the split route, every type pair; bf16 q and
    k/v with more rows the tensor cores; everything else (f32 prefill, bf16
    q against f32 k/v past the split route, unaligned operands) the SIMT
    body."""
    del causal
    if aligned and sq <= SPLIT_MAX_SQ and (h // g) * sq <= SPLIT_MAX_ROWS:
        nsplit, chunk = _split(b, g, skv)
        return FlashPlan("split", nsplit, chunk, (h // g) * sq)
    if aligned and types == TYPES[(torch.bfloat16, torch.bfloat16)]:
        return FlashPlan("tensor_core", 1, skv, TC_ROWS)
    return FlashPlan("simt", 1, skv, SIMT_ROWS)


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0 and all(
        st * t.element_size() % 16 == 0 for st in t.stride()[:3])


def plan_for(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> FlashPlan:
    """:func:`plan` of a launch on these operands (their alignment read from
    the pointers and strides)."""
    b, h, sq, d = q.shape
    return plan(b, h, k.shape[1], sq, k.shape[2], d, TYPES[(q.dtype, k.dtype)], causal,
                all(_aligned(t) for t in (q, k, v)))


def _repeat_groups(t: torch.Tensor, h: int) -> torch.Tensor:
    g = t.shape[1]
    return t if g == h else t.repeat_interleave(h // g, dim=1)


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_lengths: Optional[torch.Tensor] = None,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The plain PyTorch version of the kernel (same arguments)."""
    h = q.shape[1]
    return flash_attention_ref(
        q, _repeat_groups(k, h), _repeat_groups(v, h), kv_lengths, causal=causal, scale=scale
    )


def _check(q, k, v, kv_lengths):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    b, h, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or k.shape[1] < 1 or h % k.shape[1]:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not group q {tuple(q.shape)}")
    if kv_lengths is not None and tuple(kv_lengths.shape) != (b,):
        raise ValueError(f"flash_attention: kv_lengths {tuple(kv_lengths.shape)} != ({b},)")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_lengths: Optional[torch.Tensor] = None,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Softmax attention over ``q [B, H, Sq, d]``, ``k / v [B, G, Skv, d]``;
    see the module doc."""
    global launches
    _check(q, k, v, kv_lengths)
    b, h, sq, d = q.shape
    g, skv = k.shape[1], k.shape[2]
    dev = _device(q, k, v, kv_lengths)
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, kv_lengths, causal=causal, scale=scale)
    types = TYPES.get((q.dtype, k.dtype))
    if types is None or v.dtype != k.dtype:
        raise TypeError(f"flash_attention: no kernel for q {q.dtype}, k {k.dtype}, v {v.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {_HEAD_DIMS}")
    lane = d // 32  # elements of a row per lane: rows must align to the lane's load
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(st % lane for st in t.stride()[:3]) \
                or t.data_ptr() % (lane * t.element_size()):
            raise ValueError(f"flash_attention: {name} rows must be unit-stride and aligned "
                             f"(strides {t.stride()})")
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=dev).permute(0, 2, 1, 3)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3]
    )
    scale = float(scale) if scale is not None else 1.0 / (d ** 0.5)
    fp = plan_for(q, k, v, causal)
    # the split route's (m, l, acc[d]) partials, one per (row, split)
    work = None
    if fp.nsplit > 1:
        work = torch.empty(b * h * sq * fp.nsplit * (d + 2), dtype=torch.float32, device=dev)
    err = _build.lib().repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if kv_lengths is None else kv_lengths.data_ptr(),
        b, h, g, sq, skv, d, scale, int(causal), types, _build.addr(strides),
        ROUTES[fp.route], fp.nsplit, fp.chunk, None if work is None else work.data_ptr(),
        _build.stream_handle(),
    )
    _build.check(err, "flash_attention")
    launches += 1
    route_launches[fp.route] += 1
    return out


def _device(q, k, v, kv_lengths) -> torch.device:
    """The operands' device; for CUDA operands check the lengths' type and
    contiguity (q/k/v strides are checked by the caller)."""
    present = {"q": q, "k": k, "v": v}
    if kv_lengths is not None:
        present["kv_lengths"] = kv_lengths
    devices = {t.device for t in present.values()}
    if len(devices) != 1:
        raise ValueError(f"flash_attention: operands on several devices: "
                         f"{ {n: str(t.device) for n, t in present.items()} }")
    (dev,) = devices
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: no kernel for device {dev}")
    if dev.type == "cuda" and kv_lengths is not None and (
            kv_lengths.dtype != torch.int32 or not kv_lengths.is_contiguous()):
        raise TypeError("flash_attention: kv_lengths must be contiguous int32")
    return dev
