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

What bounds it on an H100: at decode, the K/V bytes of the span.  Routing:
a CPU tensor takes :func:`flash_attention_plain` (which repeats each KV
group to its query heads, as ``_attn_heads`` does), a CUDA tensor launches
the kernel or raises.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .ref import flash_attention_ref

__all__ = ["flash_attention", "flash_attention_plain"]

#: kernel launches made by :func:`flash_attention` (CUDA route only)
launches = 0

_TYPES = {
    (torch.float32, torch.float32): 0,
    (torch.bfloat16, torch.bfloat16): 1,
    (torch.bfloat16, torch.float32): 2,
}
_HEAD_DIMS = (32, 64, 128)


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
    types = _TYPES.get((q.dtype, k.dtype))
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
    err = _build.lib().repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if kv_lengths is None else kv_lengths.data_ptr(),
        b, h, g, sq, skv, d, scale, int(causal), types, _build.addr(strides),
        _build.stream_handle(),
    )
    _build.check(err, "flash_attention")
    launches += 1
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
