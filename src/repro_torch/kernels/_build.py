"""Build the port's CUDA kernels and bind them through ctypes.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, and the objects are linked into one shared library with a plain C
interface (no PyTorch headers: a build takes seconds, not minutes).  The
library goes to ``build/repro_torch_kernels/<hash>/`` under the repository
root, keyed by a hash of the sources and flags, so an edited kernel is
rebuilt and an unchanged one is found built.  Nothing is built at import:
the first launch (or :func:`build`) triggers it.

The wrappers call the C entry points with ``Tensor.data_ptr()`` pointers and
PyTorch's current stream, all typed ``ctypes.c_void_p``; each entry point
returns ``cudaGetLastError()`` after its launch and :func:`check` raises on
anything but 0.  Kernels allocate nothing: the wrappers allocate outputs
with ``torch.empty``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import torch

from .ref import ACTIVATIONS

__all__ = [
    "BUILD_ROOT",
    "build",
    "lib",
    "check",
    "kernel_device",
    "validate_program",
    "encode_program",
    "activation_code",
    "pointer_array",
    "addr",
    "stream_handle",
    "FLOAT_CODES",
    "skinny_plan",
    "skinny_plan_f32",
    "ffn_tile_f32",
    "ffn_split_f32",
    "gemm_split",
    "tma_plan",
    "bf16_body",
    "wgmma_shape",
    "ffn_body",
    "ffn_tma_plan",
    "split_counters",
    "GEMM_TILES",
    "BF16_GEMM_TILES",
    "FFN_WGMMA_TILES",
    "BSR_TMA_TILES",
    "CONV_TILES",
    "TileError",
    "gemm_default_tile",
    "bf16_default_tile",
    "default_gemm_tile",
    "conv_default_tile",
    "conv_w8a8_shape",
    "gemm_shape",
    "gemm_w8a8_shape",
    "LAYOUT_CODES",
    "check_gemm_tile",
    "check_conv_tile",
]

CSRC = Path(__file__).resolve().parent / "csrc"
#: the repository root (src/repro_torch/kernels/_build.py -> three levels up)
REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_ROOT = REPO_ROOT / "build" / "repro_torch_kernels"
LIB_NAME = "librepro_torch_kernels.so"
GENCODE = ("-gencode", "arch=compute_90a,code=sm_90a")

#: fixed maxima of a step program (csrc/epilogue.cuh)
MAX_STEPS, MAX_SIDES, MAX_NORMS = 8, 4, 4
_STEP_CODES = {"activation": 0, "add": 1, "mul": 2, "norm": 3}
#: arithmetic schemes of the GEMM-shaped kernels (csrc/scheme.cuh)
SCHEME_CODES = {"f32": 0, "w8": 1, "w8a8": 2}
_ACT_CODES = {name: i for i, name in enumerate(ACTIVATIONS)}
#: element types of the float kernels (``dtype`` argument of their entry points)
FLOAT_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: operand layouts of the f32 / INT8 GEMMs (csrc/simt_gemm.cuh): row-major
#: ``x [M, K]``, ``w [K, N]``, ``out [M, N]``; or NCHW ``x [nb, K, OH, OW]``,
#: ``w [N, K]``, ``out [nb, N, OH, OW]`` (the 1x1-conv path, in place)
LAYOUT_CODES = {"row": 0, "nchw": 1}

#: the skinny split-K GEMMs (M <= SKINNY_MT rows: csrc/skinny_bf16.cuh for
#: bf16, csrc/ffn_f32.cuh's streaming kernel for the f32 gate/up): most
#: rows, most K rows a block stages, the blocks to aim for (two per SM of an
#: H100's 132), and the fewest K rows of a range
SKINNY_MT, SKINNY_KC, SKINNY_TARGET_BLOCKS, SKINNY_MIN_K = 8, 1024, 264, 128
#: the f32 gate/up GEMM (csrc/ffn_f32.cuh, M > 8): the rows a tile may have
#: (:func:`ffn_tile_f32`), its columns and K slab; the blocks to aim for
#: (four per SM: the CTAs an SM holds at once), the fewest K rows of a range
#: (one slab), and the most ranges (a thread block cluster's portable size)
FFN_F32_BMS, FFN_F32_BN, FFN_F32_BK = (48, 64), 64, 16
FFN_SPLIT_TARGET, FFN_SPLIT_MIN_K, FFN_SPLIT_MAX = 528, 16, 8
#: the bf16 tensor-core GEMM's K split (csrc/mma_gemm.cuh): the blocks to
#: aim for (one per SM), the fewest and the most K rows of a range (a block
#: walks its range's slabs one after another), and the multiple a range is
#: rounded up to
SPLIT_TARGET_BLOCKS, SPLIT_MIN_K, SPLIT_MAX_K, SPLIT_ALIGN = 132, 128, 1536, 64

#: the bf16 wgmma GEMM (csrc/wgmma_gemm.cuh): the most CTAs of a thread
#: block cluster (the portable most: its K ranges), and the shared memory a
#: block can use (227 KB)
TMA_MAX_CLUSTER, SMEM_LIMIT = 8, 232448
#: the CTAs a wgmma launch's K split aims for at most: measured on an H100
#: (tools/gemm_bench.py --bf16), 192-240 CTAs ran the M = 48 prefill
#: GEMMs fastest and 256 up to 1.1x slower (no longer all resident at once)
TMA_SPLIT_TARGET = 240
#: the multiple a wgmma K range is rounded up to: every tile's BK (32, 64,
#: 128) divides it, so no slab crosses the end of a range
TMA_SPLIT_ALIGN = 128
#: the wgmma ring's bytes at most (two CTAs fit an SM) and its fewest slots
TMA_RING_BUDGET, TMA_MIN_STAGES = 110 * 1024, 4
#: the CTAs a two-weight wgmma launch (``ffn_gateup``) aims for at most:
#: two an SM, the most the first tile of :data:`FFN_WGMMA_TILES` keeps
#: resident (a 96 KB ring).  Measured on an H100 (tools/gemm_bench.py
#: --bf16 --ffn --sweep): the served gate/up shapes ran within 4% of
#: their fastest split at or below it, and more K ranges (more CTAs) up to
#: 1.6x slower
FFN_TMA_TARGET = 264
#: the wgmma body at decode (M <= SKINNY_MT, no tile named): the widest N
#: it takes from the skinny kernel, its tile (rows past M are TMA's zero
#: fill: no bytes read) and the CTAs its K split aims for at most
#: (:func:`tma_plan`).  Measured on an H100 at the served M = 3 shapes
#: (tools/wgmma_bench.py --decode, both routes in one process): the body
#: beat the skinny kernel at the k / v projections (N 256 / 512 / 1024:
#: 0.0046 / 0.0045 / 0.0056 ms against 0.0059 / 0.0058 / 0.0070), lost at
#: every q / o (N 2048 / 3072: 0.0071-0.0120 against 0.0065-0.0101) under
#: every tile and K split swept, and split the down projections (qwen /
#: phi4 4-5% faster, granite 33% slower), which stay skinny; phi4's k / v
#: ran 0.0056 ms on 6 ranges (96 CTAs) against 0.0062 on 8.  No N between
#: 1024 and 2048 was measured: the cut lies somewhere in that gap
TMA_DECODE_MAX_N, TMA_DECODE_TILE, TMA_DECODE_TARGET = 1024, (64, 64, 64, 1), 96
#: bsr_matmul's wgmma route (csrc/bsr_matmul.cu over csrc/wgmma_gemm.cuh,
#: a 64-row M tile at depth 1): ``(BN, BK)`` instances, BN the columns of a
#: block-column a CTA covers, BK the rows of a slab (``bsr_matmul.tma_bk``);
#: ``csrc/tiles.cuh`` (``REPRO_BSR_TMA_TILES``) lists the same pairs
BSR_TMA_TILES = ((64, 128), (64, 64), (64, 32), (32, 128), (32, 64), (32, 32))
#: the limits csrc/wgmma_gemm.cuh is compiled with (``-DREPRO_WGMMA_<key>``):
#: the header keeps no copy of its own
WGMMA_LIMITS = dict(MAX_CLUSTER=TMA_MAX_CLUSTER, SMEM_LIMIT=SMEM_LIMIT,
                    RING_BUDGET=TMA_RING_BUDGET, MIN_STAGES=TMA_MIN_STAGES,
                    SPLIT_ALIGN=TMA_SPLIT_ALIGN)
NVCC_FLAGS = GENCODE + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v") + tuple(
    f"-DREPRO_WGMMA_{key}={value}" for key, value in WGMMA_LIMITS.items())

#: the tiles the GEMM kernels are built for, ``(block_m, block_n, block_k,
#: pipeline_depth)``: depth 1 is the tiled kernel (``csrc/dense_matmul.cu``,
#: ``csrc/quant_matmul.cu``), depth >= 2 the K-slab ring
#: (``csrc/*_pipelined.cu``); each for every element type (f32, bf16) and
#: scheme (W8, W8A8).  ``csrc/tiles.cuh`` lists the same tiles.
GEMM_TILES = (
    (128, 32, 16, 1), (64, 64, 16, 1), (128, 64, 16, 1), (64, 64, 32, 1),
    (128, 32, 16, 2), (64, 64, 16, 2), (128, 32, 16, 3), (64, 64, 16, 3),
)
#: the bf16 tensor-core kernel's tiles (``csrc/mma_gemm.cuh``), its own
#: list: ``(block_m, block_n, block_k, depth)``, depth 1 in
#: ``dense_matmul`` and ``ffn_gateup``, 2 and 3 in
#: ``dense_matmul_pipelined`` (a ring of depth + 2 slots).  The first three
#: are the shape-based defaults (:func:`bf16_default_tile`), each also at
#: depth 2 and 3.  ``csrc/tiles.cuh`` lists the same tiles.
BF16_GEMM_TILES = (
    (64, 64, 64, 1), (64, 32, 64, 1), (128, 64, 32, 1), (64, 64, 128, 1),
    (64, 64, 64, 2), (64, 32, 64, 2), (128, 64, 32, 2),
    (64, 64, 64, 3), (64, 32, 64, 3), (128, 64, 32, 3),
)
#: the two-weight wgmma body's tiles (``ffn_gateup``, ``csrc/fused_ffn.cu``
#: over ``csrc/wgmma_gemm.cuh`` with NW = 2), ``(block_m, block_n, block_k,
#: depth)``: a 96 KB ring of four 24 KB slots (two CTAs an SM), and a 48 KB
#: ring of four 12 KB slots (four an SM), :func:`ffn_tma_plan`'s choice for
#: grids the first cannot keep resident; both give the same bits for a
#: shape.  ``csrc/tiles.cuh`` (``REPRO_FFN_WGMMA_TILES``) lists the same
#: tiles.
FFN_WGMMA_TILES = ((64, 64, 64, 1), (64, 64, 32, 1))
#: the conv kernel's tiles, ``(BM, BN, BK)``: output pixels x output
#: channels x K slab, each for every scheme (``csrc/tiles.cuh``)
CONV_TILES = (
    (256, 4, 16), (256, 16, 16), (128, 32, 16), (64, 64, 16), (256, 32, 16), (128, 64, 16),
)


class TileError(ValueError):
    """A tile the kernels are not built for (from a pin or a cache entry)."""


def gemm_default_tile(n: int) -> Tuple[int, int, int, int]:
    """The GEMM kernels' tile when neither a pin nor the tuning cache names
    one: by the output width, as the kernels chose before the cache."""
    return (128, 32, 16, 1) if n <= 32 else (64, 64, 16, 1)


def bf16_default_tile(m: int, n: int) -> Tuple[int, int, int, int]:
    """The bf16 tensor-core kernel's tile when neither a pin nor the cache
    names one: 64 rows up to M = 64 (the decoder's prefill, M = batch x
    prompt), else 128; 32 columns up to N = 256 (k / v), else 64."""
    if m > 64:
        return (128, 64, 32, 1)
    return (64, 32 if n <= 256 else 64, 64, 1)


def default_gemm_tile(m: int, n: int, dtype) -> Tuple[int, int, int, int]:
    """The default tile of a dense GEMM of ``dtype``: the bf16 kernel's
    (:func:`bf16_default_tile`) or the f32 / INT8 kernels'
    (:func:`gemm_default_tile`)."""
    return bf16_default_tile(m, n) if dtype == torch.bfloat16 else gemm_default_tile(n)


def conv_default_tile(scheme: str, o: int) -> Tuple[int, int, int]:
    """The conv kernel's default tile, by the output-channel count: for f32
    256 x 4 up to O = 4, 256 x 16 up to 16, 256 x 32 up to 32, 64 x 64
    wider; W8 (the f32 body) 256 x 32 up to 32, 64 x 64 wider; W8A8 (its
    own body on int8 tensor cores, :func:`conv_w8a8_shape`) 128 x 32 up to
    32, 64 x 64 wider.  256 x 32 is the f32 / W8 body's fastest tile on the
    apps' 32-channel convs at 256 x 256 (3x3 96-of-192->32 +add 0.534 ms
    against 128 x 32's 0.573, 7x7 3->32 0.145 against 0.156; H100,
    tools/bsr_conv_bench.py --tiles); 64 x 64 stays W8A8's fastest on its
    128-channel convs (3x3 64-of-128->128 0.0274 ms against 128 x 64's
    0.0292)."""
    if scheme == "f32" and o <= 4:
        return (256, 4, 16)
    if scheme == "f32" and o <= 16:
        return (256, 16, 16)
    if o <= 32:
        return (128, 32, 16) if scheme == "w8a8" else (256, 32, 16)
    return (64, 64, 16)


def conv_w8a8_shape(tile: Sequence[int]) -> Dict[str, int]:
    """The W8A8 body's own tile, derived from a conv tile ``(BM, BN, BK)``
    as ``csrc/conv2d.cu:Int8ConvShape`` derives it: ``bm`` pixels (two m16
    blocks a warp), ``bn = max(2 * BN, 8)`` channels (the patch gather,
    not the int8 mma, is that body's cost, so a CTA covers twice the f32
    tile's channels for each gathered patch; a multiple of the mma's n8),
    ``bk = 4 * BK`` k a slab (a multiple of the m16n8k32 mma's 32), warps
    of 32 x ``warp_n`` outputs, ``threads`` a CTA, ``pixels`` a thread
    gathers, and the shared memory in bytes (two patch and two filter slabs
    of 16-byte-padded rows, two k tables)."""
    bm, bn, bk = (int(v) for v in tile[:3])
    bn8, bk8 = max(2 * bn, 8), 4 * bk
    warp_n = min(bn8, 32)
    threads = (bm // 32) * (bn8 // warp_n) * 32
    smem = 2 * (bm + bn8) * (bk8 + 16) + 2 * bk8 * 16
    return dict(bm=bm, bn=bn8, bk=bk8, warp_n=warp_n, threads=threads,
                pixels=2 if bm >= 64 else 1, smem=smem)


def gemm_shape(tile: Sequence[int]) -> Dict[str, int]:
    """The f32 / W8 GEMM body's layout for a tile ``(BM, BN, BK[, depth])``
    of :data:`GEMM_TILES`, as ``csrc/simt_gemm.cuh:Shape`` derives it: an
    ``tm x tn`` micro-tile of 4-pixel x 4-channel groups a thread (8 x 8
    where the tile has 128 x 64 outputs or more, else 8 x 4), ``threads`` a
    CTA, warps of ``lx`` x ``ly`` threads (pixels x channels), ``slots``
    x slabs (depth + 1, ``depth`` in flight) of ``bk`` k x ``bm + 4``
    floats and two w slabs of ``bk`` x ``bn + 4``, then the epilogue's
    output tile (``bn`` rows of ``bm + 4`` floats or ``bm`` of ``bn + 4``,
    the larger): ``smem`` bytes of dynamic shared memory."""
    bm, bn, bk = (int(v) for v in tile[:3])
    depth = int(tile[3]) if len(tile) > 3 else 1
    tm, tn = 8, 8 if bm * bn // 64 >= 128 else 4
    tx, ty = bm // tm, bn // tn
    ly = min(ty, 4)
    slots = depth + 1
    return dict(bm=bm, bn=bn, bk=bk, depth=depth, tm=tm, tn=tn, tx=tx, ty=ty,
                threads=tx * ty, lx=32 // ly, ly=ly, slots=slots,
                w_per_thread=bk * bn // (tx * ty),
                smem=4 * (slots * bk * (bm + 4) + 2 * bk * (bn + 4)
                          + max(bm * (bn + 4), bn * (bm + 4))))


def gemm_w8a8_shape(tile: Sequence[int]) -> Dict[str, int]:
    """The W8A8 GEMM body's tile for a tile ``(BM, BN, BK[, depth])`` of
    :data:`GEMM_TILES`, as ``csrc/int8_gemm.cuh:Shape`` derives it: ``bm``
    x ``bn`` outputs, ``bk = 4 * BK`` k a slab (a multiple of the m16n8k32
    mma's 32), warps of 32 x ``warp_n`` outputs, ``threads`` a CTA, and
    ``slots`` slabs of ``bm + bn`` rows of ``bk + 16`` bytes, whose bytes
    the epilogue's f32 output tile reuses: ``smem`` bytes (dynamic shared
    memory), the larger of the two."""
    bm, bn, bk = (int(v) for v in tile[:3])
    depth = int(tile[3]) if len(tile) > 3 else 1
    bk8 = 4 * bk
    warp_n = min(bn, 32)
    threads = (bm // 32) * (bn // warp_n) * 32
    slots = depth + 1
    return dict(bm=bm, bn=bn, bk=bk8, depth=depth, warp_n=warp_n, threads=threads,
                slots=slots, smem=max(slots * (bm + bn) * (bk8 + 16),
                                      4 * max(bm * (bn + 4), bn * (bm + 4))))


_GEMM_TILE_SET = frozenset(GEMM_TILES)
_BF16_TILE_SET = frozenset(BF16_GEMM_TILES)
_CONV_TILE_SET = frozenset(CONV_TILES)


def _check_tile(tile, tiles, built, kernels, what):
    if type(tile) is tuple and tile in built:  # the per-call path: no copy
        return tile
    t = tuple(int(v) for v in tile)
    if t not in built:
        what = what() if callable(what) else what
        raise TileError(f"{what}: tile {t} is not instantiated ({kernels} have {list(tiles)})")
    return t


def check_gemm_tile(tile: Sequence[int], what="GEMM",
                    dtype=torch.float32) -> Tuple[int, int, int, int]:
    """``tile`` as a tuple if the GEMM kernels of ``dtype`` are built for it
    (bf16: :data:`BF16_GEMM_TILES`, else :data:`GEMM_TILES`), else raise
    :class:`TileError` naming ``what`` (a tuning key or the wrapper; a
    callable is called only to build the message)."""
    if dtype == torch.bfloat16:
        return _check_tile(tile, BF16_GEMM_TILES, _BF16_TILE_SET, "the bf16 GEMM kernels", what)
    return _check_tile(tile, GEMM_TILES, _GEMM_TILE_SET, "the GEMM kernels", what)


def check_conv_tile(tile: Sequence[int], what="conv2d") -> Tuple[int, int, int]:
    """``tile`` as a tuple if the conv kernel is built for it, else raise
    :class:`TileError` (``what`` as for :func:`check_gemm_tile`)."""
    return _check_tile(tile, CONV_TILES, _CONV_TILE_SET, "the conv kernel", what)


_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def _sources() -> Tuple[Sequence[Path], Sequence[Path]]:
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    """Hash of every kernel source, header and compiler flag."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [p for group in _sources() for p in group]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels (one nvcc per source, in parallel) and link them
    into one shared library; return its path.  A library already built from
    the same sources is returned as it is.  The compiler's report (ptxas
    registers, shared memory and spills per kernel) is kept beside it in
    ``build.log``."""
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    cus, _ = _sources()
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in cus]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(cus, objs)
        ]
        logs = []
        failed = []
        for src, p in zip(cus, procs):
            out, _ = p.communicate()
            logs.append(f"== {src.name}\n{out}")
            if p.returncode:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, *GENCODE, "-shared", "-o", str(tmp_lib), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        (out_dir / "build.log").write_text("\n".join(logs) + link.stdout)
        os.replace(tmp_lib, lib_path)  # atomic: a concurrent builder sees all or nothing
    return lib_path


def _bind(cdll: ctypes.CDLL) -> ctypes.CDLL:
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    cdll.repro_dense_matmul.argtypes = [P, P, P, P] + [I] * 5 + [P, I, P, I, P, P] + [I] * 8 + [P]
    cdll.repro_dense_matmul.restype = I
    cdll.repro_dense_matmul_pipelined.argtypes = (
        [P] * 4 + [I] * 5 + [P, I, P, I, P, P] + [I] * 8 + [P])
    cdll.repro_dense_matmul_pipelined.restype = I
    cdll.repro_ffn_gateup.argtypes = [P, P, P, P, I, I, I, I, I, P, P] + [I] * 7 + [P]
    cdll.repro_ffn_gateup.restype = I
    cdll.repro_flash_attention.argtypes = (
        [P] * 5 + [I] * 6 + [ctypes.c_float, I, I, P] + [I] * 3 + [P, P])
    cdll.repro_flash_attention.restype = I
    cdll.repro_conv2d.argtypes = [P] * 6 + [I] * 15 + [I, P, I, P] + [I] * 3 + [P]
    cdll.repro_conv2d.restype = I
    cdll.repro_quant_matmul.argtypes = [P] * 5 + [I] * 5 + [I, P, I, P] + [I] * 5 + [P]
    cdll.repro_quant_matmul.restype = I
    cdll.repro_quant_matmul_pipelined.argtypes = [P] * 5 + [I] * 5 + [I, P, I, P] + [I] * 6 + [P]
    cdll.repro_quant_matmul_pipelined.restype = I
    cdll.repro_fused_elementwise.argtypes = [P, P, L, I, I, P, P, I, P, I, P, P]
    cdll.repro_fused_elementwise.restype = I
    cdll.repro_fused_elementwise_max_d.argtypes = []
    cdll.repro_fused_elementwise_max_d.restype = I
    cdll.repro_bsr_matmul.argtypes = [P] * 5 + [I] * 11 + [P, I, P] + [I] * 4 + [P, P, P]
    cdll.repro_bsr_matmul.restype = I
    cdll.repro_error_string.argtypes = [I]
    cdll.repro_error_string.restype = ctypes.c_char_p
    return cdll


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _bind(ctypes.CDLL(str(build())))
        return _LIB


def check(err: int, name: str) -> None:
    """Raise when a C entry point reports a CUDA error (a refused launch
    never runs, and a later synchronize would not report it)."""
    if err:
        msg = lib().repro_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def stream_handle() -> int:
    return torch.cuda.current_stream().cuda_stream


def kernel_device(
    name: str, dtypes: Optional[Dict[str, torch.dtype]] = None, **tensors: Optional[torch.Tensor]
) -> torch.device:
    """The device every given operand lies on.  For CUDA operands, check
    what the kernels take (f32 data, int32 ``kept`` indices, or the dtype
    ``dtypes`` names for an operand -- int8 for quantized ones; contiguous)
    and raise on anything else; CPU operands go to the plain versions
    unchecked."""
    present = {k: t for k, t in tensors.items() if t is not None}
    devices = {t.device for t in present.values()}
    if len(devices) != 1:
        raise ValueError(f"{name}: operands on several devices: "
                         f"{ {k: str(t.device) for k, t in present.items()} }")
    (dev,) = devices
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    dtypes = dtypes or {}
    for k, t in present.items():
        want = dtypes.get(k, torch.int32 if k == "kept" else torch.float32)
        if t.dtype != want:
            raise TypeError(f"{name}: {k} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")
    return dev


def validate_program(steps, n_sides: int, n_norms: int = 0, *, norms_ok: bool = False):
    """Check a kernel-local step program against the kernels' opcode set and
    fixed maxima (the ``validate_epilogue`` contract of the JAX kernels)."""
    if len(steps) > MAX_STEPS or n_sides > MAX_SIDES or n_norms > MAX_NORMS:
        raise ValueError(
            f"step program too large: {len(steps)} steps / {n_sides} sides / "
            f"{n_norms} norms (max {MAX_STEPS}/{MAX_SIDES}/{MAX_NORMS})"
        )
    for step in steps:
        kind = step[0]
        if kind == "activation":
            if step[1] not in _ACT_CODES:
                raise ValueError(f"unknown epilogue activation {step[1]!r}")
        elif kind in ("add", "mul"):
            if not 0 <= step[1] < n_sides:
                raise ValueError(f"epilogue slot {step[1]} out of range ({n_sides} sides)")
        elif kind == "norm" and norms_ok:
            if not 0 <= step[1] < n_norms:
                raise ValueError(f"norm slot {step[1]} out of range ({n_norms} norms)")
        else:
            raise NotImplementedError(f"epilogue step {kind}")


def encode_program(steps) -> Dict[str, object]:
    """ctypes arrays for a validated step program: (kind, arg) int pairs and
    one eps per step."""
    n = len(steps)
    prog = (ctypes.c_int * max(2 * n, 1))()
    eps = (ctypes.c_float * max(n, 1))()
    for i, step in enumerate(steps):
        kind = step[0]
        prog[2 * i] = _STEP_CODES[kind]
        prog[2 * i + 1] = _ACT_CODES[step[1]] if kind == "activation" else int(step[1])
        eps[i] = float(step[2]) if kind == "norm" else 0.0
    return {"n": n, "prog": prog, "eps": eps}


def activation_code(activation: Optional[str]) -> int:
    if activation not in _ACT_CODES:
        raise ValueError(f"unknown activation {activation!r}")
    return _ACT_CODES[activation]


def pointer_array(tensors: Sequence[torch.Tensor]):
    """Host array of device pointers; the caller keeps it (and the tensors)
    referenced for the duration of the call and passes ``addressof`` it."""
    arr = (ctypes.c_void_p * max(len(tensors), 1))()
    for i, t in enumerate(tensors):
        arr[i] = t.data_ptr()
    return arr


def addr(arr) -> int:
    """Address of a ctypes array, for a ``c_void_p`` argument."""
    return ctypes.addressof(arr)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def skinny_plan(m: int, n: int, k: int, vec: int) -> Tuple[int, int, int]:
    """``(kchunk, nsplit, tiles)`` of a bf16 skinny launch
    (``csrc/skinny_bf16.cuh``, M <= 8): the K rows of a range (a multiple
    of 32, at most ``SKINNY_KC``), the number of ranges, and the number of
    column tiles (``8 * vec`` columns each, one counter each).  The ranges
    are the fewest that give about ``SKINNY_TARGET_BLOCKS`` blocks, each at
    least ``SKINNY_MIN_K`` rows long (or all of K); fixed by the shape."""
    tiles = _cdiv(n, 8 * vec)
    nsplit = min(_cdiv(SKINNY_TARGET_BLOCKS, tiles), max(1, k // SKINNY_MIN_K))
    nsplit = max(nsplit, _cdiv(k, SKINNY_KC), 1)
    kchunk = min(SKINNY_KC, _cdiv(_cdiv(k, nsplit), 32) * 32)
    return kchunk, _cdiv(k, kchunk), tiles


def skinny_plan_f32(m: int, n: int, k: int, vec: int) -> Tuple[int, int, int]:
    """``(kchunk, nsplit, tiles)`` of the f32 gate/up streaming launch
    (``csrc/ffn_f32.cuh``, M <= 8): :func:`skinny_plan`'s K ranges on the
    16-byte column tile (``8 * 4`` f32 columns) whatever ``vec`` is -- so
    the 4-byte route sums each output over the same ranges -- and the
    column tiles of ``vec`` (``8 * vec`` columns, one counter each)."""
    kchunk, nsplit, _ = skinny_plan(m, n, k, 4)
    return kchunk, nsplit, _cdiv(n, 8 * vec)


def ffn_tile_f32(m: int) -> Tuple[int, int, int]:
    """``(bm, bn, bk)`` of the f32 gate/up GEMM (``csrc/ffn_f32.cuh``, M >
    8): the tile rows of ``FFN_F32_BMS`` that pad ``m`` least (the larger on
    a tie), 64 columns, 16-deep K slabs."""
    bm = min(FFN_F32_BMS, key=lambda b: (_cdiv(m, b) * b, -b))
    return bm, FFN_F32_BN, FFN_F32_BK


def ffn_split_f32(m: int, n: int, k: int) -> Tuple[int, int]:
    """``(kchunk, nsplit)``: the K ranges of the f32 gate/up GEMM, fixed by
    the shape.  One range where the tiles of :func:`ffn_tile_f32` are more
    than half of ``FFN_SPLIT_TARGET`` blocks; else as many ranges as fit the
    target, none shorter than ``FFN_SPLIT_MIN_K`` rows, at most
    ``FFN_SPLIT_MAX`` (a tile's ranges form one thread block cluster);
    whole slabs each (the last may be shorter)."""
    bm, bn, bk = ffn_tile_f32(m)
    if k <= 0:
        return bk, 1
    tiles = _cdiv(m, bm) * _cdiv(n, bn)
    nsplit = max(1, min(FFN_SPLIT_TARGET // tiles, k // FFN_SPLIT_MIN_K, FFN_SPLIT_MAX))
    kchunk = _cdiv(_cdiv(k, nsplit), bk) * bk
    return kchunk, _cdiv(k, kchunk)


def gemm_split(m: int, n: int, k: int) -> Tuple[int, int]:
    """``(kchunk, nsplit)``: the K ranges of a bf16 tensor-core GEMM
    (``csrc/mma_gemm.cuh``), fixed by the shape alone -- never by the tile
    or depth a call runs, so every tile and depth sums each output over the
    same ranges and stays bit-equal.  One range where the default tile's
    grid (:func:`bf16_default_tile`) alone holds ``SPLIT_TARGET_BLOCKS``
    blocks; else enough ranges for that many blocks and for ranges of at
    most ``SPLIT_MAX_K`` rows, none shorter than ``SPLIT_MIN_K`` rows; each
    a multiple of ``SPLIT_ALIGN`` rows (the last may be shorter)."""
    if k <= 0:
        return 1, 1
    bm, bn, _, _ = bf16_default_tile(m, n)
    tiles = _cdiv(m, bm) * _cdiv(n, bn)
    nsplit = 1
    if tiles < SPLIT_TARGET_BLOCKS:
        nsplit = max(_cdiv(SPLIT_TARGET_BLOCKS, tiles), _cdiv(k, SPLIT_MAX_K))
        nsplit = max(1, min(nsplit, k // SPLIT_MIN_K))
    kchunk = _cdiv(_cdiv(k, nsplit), SPLIT_ALIGN) * SPLIT_ALIGN
    return kchunk, _cdiv(k, kchunk)


def bf16_body(m: int, n: int, k: int, named: bool = False, aligned: bool = True) -> str:
    """Which body a bf16 ``dense_matmul`` / ``dense_matmul_pipelined``
    launch of ``x [m, k] @ w [k, n]`` runs -- a rule on the shape (and on
    the operands' alignment, ``aligned``: x, w and out 16-byte aligned),
    never a recovery.  At most ``SKINNY_MT`` rows with no tile named (the
    tiled entry at decode): ``"wgmma"`` on ``TMA_DECODE_TILE`` where
    TMA addresses the operands and N is at most ``TMA_DECODE_MAX_N``, else
    ``"skinny"`` (``csrc/skinny_bf16.cuh``) for K > 0.  Otherwise
    ``"wgmma"`` (``csrc/wgmma_gemm.cuh``, TMA + wgmma) where TMA addresses
    the operands -- aligned, K and N multiples of 8 (row strides of whole
    16 bytes), K > 0 --, else ``"mma_gemm"`` (``csrc/mma_gemm.cuh``)."""
    tma = aligned and k > 0 and k % 8 == 0 and n % 8 == 0
    if m <= SKINNY_MT and k > 0 and not named and not (tma and n <= TMA_DECODE_MAX_N):
        return "skinny"
    return "wgmma" if tma else "mma_gemm"


def tma_plan(m: int, n: int, k: int) -> Tuple[int, int]:
    """``(kchunk, nsplit)`` of a wgmma launch (``csrc/wgmma_gemm.cuh``),
    fixed by the shape alone -- never by the tile or depth, so every tile
    and depth sums each output over the same ranges and stays bit-equal.
    K ranges: one where the grid of the shape's tile alone holds the
    target; else as many as that grid can add without passing it (the
    ranges of a tile are one thread block cluster: at most
    ``TMA_MAX_CLUSTER``), none shorter than ``SPLIT_MIN_K`` rows, each a
    multiple of ``TMA_SPLIT_ALIGN`` rows (the last may be shorter).  The
    tile and target: where an untiled launch of the shape takes the body
    at decode (at most ``SKINNY_MT`` rows, N at most ``TMA_DECODE_MAX_N``;
    outside the tuning cache as the skinny route's plan was)
    ``TMA_DECODE_TILE`` and ``TMA_DECODE_TARGET``, else
    :func:`bf16_default_tile` and ``TMA_SPLIT_TARGET`` (a named tile at
    decode on a wider N: more ranges, as the down projection measured)."""
    if m <= SKINNY_MT and n <= TMA_DECODE_MAX_N:
        (bm, bn, _, _), target = TMA_DECODE_TILE, TMA_DECODE_TARGET
    else:
        (bm, bn, _, _), target = bf16_default_tile(m, n), TMA_SPLIT_TARGET
    tiles = _cdiv(m, bm) * _cdiv(n, bn)
    nsplit = max(1, min(target // tiles, TMA_MAX_CLUSTER, k // SPLIT_MIN_K))
    kchunk = _cdiv(_cdiv(max(k, 1), nsplit), TMA_SPLIT_ALIGN) * TMA_SPLIT_ALIGN
    return kchunk, _cdiv(max(k, 1), kchunk)


def wgmma_shape(tile: Sequence[int], nw: int = 1) -> Dict[str, int]:
    """The wgmma body's layout for a tile ``(BM, BN, BK, depth)`` with
    ``nw`` weights (1: :data:`BF16_GEMM_TILES`; 2: :data:`FFN_WGMMA_TILES`),
    as ``csrc/wgmma_gemm.cuh:Tile`` derives it: ``BM / 64`` consumer
    warpgroups and a producer warp (``threads``), a ring of ``2 + 2 *
    depth`` slots of ``BM x BK`` x and ``nw`` times ``BK x BN`` w bf16 as
    far as ``TMA_RING_BUDGET`` bytes hold them, never fewer than
    ``TMA_MIN_STAGES`` (``stages``), the ``nw`` partial tiles (``BM`` rows
    of ``BN + 8`` floats each, ``partial`` bytes in all) over the drained
    ring, two barriers a slot and 1024 bytes to align the ring: ``smem``
    bytes of dynamic shared memory."""
    bm, bn, bk, depth = (int(v) for v in tile)
    slot = 2 * (bm * bk + nw * bk * bn)
    stages = max(min(2 + 2 * depth, TMA_RING_BUDGET // slot), TMA_MIN_STAGES)
    ring = stages * slot
    return dict(warpgroups=bm // 64, threads=bm // 64 * 128 + 32, stages=stages, ring=ring,
                partial=nw * bm * (bn + 8) * 4, smem=ring + 2 * stages * 8 + 1024)


def ffn_body(f: int, k: int, aligned: bool = True) -> str:
    """Which body a bf16 ``ffn_gateup`` launch of ``x [M, k]`` against two
    ``[k, f]`` weights runs -- a rule on the shape and the operands'
    alignment (``aligned``: x, both weights and out 16-byte aligned), never
    a recovery: ``"wgmma"`` (``csrc/wgmma_gemm.cuh`` with two weights)
    where TMA addresses the operands -- aligned, K and F multiples of 8, K
    > 0 --, at every M (at decode too: 1.35-1.44x faster than the
    weight-streaming skinny kernel at the served M = 3 shapes on an H100,
    tools/gemm_bench.py --bf16 --ffn); else ``"mma_gemm"``
    (``csrc/mma_gemm.cuh``)."""
    if aligned and k > 0 and k % 8 == 0 and f % 8 == 0:
        return "wgmma"
    return "mma_gemm"


def ffn_tma_plan(m: int, f: int, k: int) -> Tuple[Tuple[int, int, int, int], int, int]:
    """``(tile, kchunk, nsplit)`` of a two-weight wgmma launch
    (``ffn_gateup``), fixed by the shape alone.  Tile: the first of
    :data:`FFN_WGMMA_TILES` while its grid (``ceil(m / 64) x ceil(f /
    64)`` tiles) holds at most ``FFN_TMA_TARGET`` CTAs, else the second,
    whose smaller ring keeps a wider grid resident in one wave.  K ranges:
    one where the grid alone holds ``FFN_TMA_TARGET`` CTAs, else as many
    as it can add without passing the target (a tile's ranges are one
    thread block cluster: at most ``TMA_MAX_CLUSTER``), none shorter than
    ``SPLIT_MIN_K`` rows, each a multiple of ``TMA_SPLIT_ALIGN`` rows (the
    last may be shorter).  The ranges depend on no tile, so every tile of
    the list sums each output over the same ranges and gives the same
    bits."""
    tile = FFN_WGMMA_TILES[0]
    tiles = _cdiv(m, tile[0]) * _cdiv(f, tile[1])
    if tiles > FFN_TMA_TARGET:
        tile = FFN_WGMMA_TILES[1]
    nsplit = max(1, min(FFN_TMA_TARGET // tiles, TMA_MAX_CLUSTER, k // SPLIT_MIN_K))
    kchunk = _cdiv(_cdiv(max(k, 1), nsplit), TMA_SPLIT_ALIGN) * TMA_SPLIT_ALIGN
    return tile, kchunk, _cdiv(max(k, 1), kchunk)


#: (device, stream) -> int32 tile counters, zero between launches: the
#: split kernels of csrc/mma_gemm.cuh, csrc/skinny_bf16.cuh,
#: csrc/ffn_f32.cuh and csrc/bsr_matmul.cu reset each counter they use
#: before they exit
_COUNTERS: Dict[Tuple[torch.device, int], torch.Tensor] = {}
#: counter buffers :func:`split_counters` has allocated (a zeroing
#: allocation each), so a run can show that split launches make none
counter_allocations = 0


def split_counters(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 tile counters for a split launch on the
    current stream, from a buffer kept per device and stream (the kernels
    leave them zeroed, so no memset per call)."""
    global counter_allocations
    key = (device, stream_handle())
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _COUNTERS[key] = buf
        counter_allocations += 1
    return buf
