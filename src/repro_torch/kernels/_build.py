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
    "gemm_split",
    "split_counters",
    "GEMM_TILES",
    "BF16_GEMM_TILES",
    "CONV_TILES",
    "TileError",
    "gemm_default_tile",
    "bf16_default_tile",
    "default_gemm_tile",
    "conv_default_tile",
    "check_gemm_tile",
    "check_conv_tile",
]

CSRC = Path(__file__).resolve().parent / "csrc"
#: the repository root (src/repro_torch/kernels/_build.py -> three levels up)
REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_ROOT = REPO_ROOT / "build" / "repro_torch_kernels"
LIB_NAME = "librepro_torch_kernels.so"
GENCODE = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = GENCODE + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

#: fixed maxima of a step program (csrc/epilogue.cuh)
MAX_STEPS, MAX_SIDES, MAX_NORMS = 8, 4, 4
_STEP_CODES = {"activation": 0, "add": 1, "mul": 2, "norm": 3}
#: arithmetic schemes of the GEMM-shaped kernels (csrc/scheme.cuh)
SCHEME_CODES = {"f32": 0, "w8": 1, "w8a8": 2}
_ACT_CODES = {name: i for i, name in enumerate(ACTIVATIONS)}
#: element types of the float kernels (``dtype`` argument of their entry points)
FLOAT_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: the skinny split-K GEMMs (M <= SKINNY_MT rows: csrc/skinny_bf16.cuh for
#: bf16, csrc/skinny_gemm.cuh for the f32 gate/up): most rows, most K rows
#: a block stages, the blocks to aim for (two per SM of an H100's 132), and
#: the fewest K rows of a bf16 range
SKINNY_MT, SKINNY_KC, SKINNY_TARGET_BLOCKS, SKINNY_MIN_K = 8, 1024, 264, 128
#: the bf16 tensor-core GEMM's K split (csrc/mma_gemm.cuh): the blocks to
#: aim for (one per SM), the fewest and the most K rows of a range (a block
#: walks its range's slabs one after another), and the multiple a range is
#: rounded up to
SPLIT_TARGET_BLOCKS, SPLIT_MIN_K, SPLIT_MAX_K, SPLIT_ALIGN = 132, 128, 1536, 64

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
    """The conv kernel's default tile: by the output-channel count, over four
    tiles for f32 and two for the INT8 schemes, as before the cache."""
    if scheme == "f32" and o <= 4:
        return (256, 4, 16)
    if scheme == "f32" and o <= 16:
        return (256, 16, 16)
    return (128, 32, 16) if o <= 32 else (64, 64, 16)


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
    cdll.repro_dense_matmul.argtypes = [P, P, P, P] + [I] * 5 + [P, I, P, I, P, P] + [I] * 5 + [P]
    cdll.repro_dense_matmul.restype = I
    cdll.repro_dense_matmul_pipelined.argtypes = (
        [P] * 4 + [I] * 5 + [P, I, P, I, P, P] + [I] * 5 + [P])
    cdll.repro_dense_matmul_pipelined.restype = I
    cdll.repro_ffn_gateup.argtypes = [P, P, P, P, I, I, I, I, I, P, P] + [I] * 5 + [P]
    cdll.repro_ffn_gateup.restype = I
    cdll.repro_flash_attention.argtypes = [P] * 5 + [I] * 6 + [ctypes.c_float, I, I, P, P]
    cdll.repro_flash_attention.restype = I
    cdll.repro_conv2d.argtypes = [P] * 6 + [I] * 15 + [I, P, I, P] + [I] * 3 + [P]
    cdll.repro_conv2d.restype = I
    cdll.repro_quant_matmul.argtypes = [P] * 5 + [I] * 5 + [I, P, I, P] + [I] * 3 + [P]
    cdll.repro_quant_matmul.restype = I
    cdll.repro_quant_matmul_pipelined.argtypes = [P] * 5 + [I] * 5 + [I, P, I, P] + [I] * 4 + [P]
    cdll.repro_quant_matmul_pipelined.restype = I
    cdll.repro_fused_elementwise.argtypes = [P, P, L, I, I, P, P, I, P, I, P, P]
    cdll.repro_fused_elementwise.restype = I
    cdll.repro_fused_elementwise_max_d.argtypes = []
    cdll.repro_fused_elementwise_max_d.restype = I
    cdll.repro_bsr_matmul.argtypes = [P] * 5 + [I] * 11 + [P, I, P] + [I] * 3 + [P, P, P]
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
    """``(kchunk, nsplit, tiles)`` of the f32 gate/up skinny launch
    (``csrc/skinny_gemm.cuh``, M <= 8): the K chunk per block (at most
    ``SKINNY_KC``), the number of K splits, and the number of output tiles
    (one counter each).  The splits are chosen so that the grid has about
    ``SKINNY_TARGET_BLOCKS`` blocks, at least 64 K rows each."""
    tiles = _cdiv(n, 32 * vec) * _cdiv(m, SKINNY_MT)
    nsplit = max(_cdiv(SKINNY_TARGET_BLOCKS, tiles), _cdiv(k, SKINNY_KC), 1)
    nsplit = min(nsplit, max(1, _cdiv(k, 64)))  # at least 64 K rows per block
    nsplit = max(nsplit, _cdiv(k, SKINNY_KC))
    kchunk = _cdiv(k, nsplit)
    return kchunk, _cdiv(k, kchunk), tiles


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


#: (device, stream) -> int32 tile counters, zero between launches: the
#: split kernels of csrc/mma_gemm.cuh and csrc/skinny_bf16.cuh reset each
#: counter they use before they exit
_COUNTERS: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def split_counters(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 tile counters for a split launch on the
    current stream, from a buffer kept per device and stream (the kernels
    leave them zeroed, so no memset per call)."""
    key = (device, stream_handle())
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _COUNTERS[key] = buf
    return buf
