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
    "GEMM_TILES",
    "CONV_TILES",
    "TileError",
    "gemm_default_tile",
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

#: the skinny split-K GEMM's fixed shape (csrc/skinny_gemm.cuh): rows per
#: block, most K rows a block stages, and the blocks to aim for (two per SM
#: of an H100's 132)
SKINNY_MT, SKINNY_KC, SKINNY_TARGET_BLOCKS = 8, 1024, 264

#: the tiles the GEMM kernels are built for, ``(block_m, block_n, block_k,
#: pipeline_depth)``: depth 1 is the tiled kernel (``csrc/dense_matmul.cu``,
#: ``csrc/quant_matmul.cu``), depth >= 2 the K-slab ring
#: (``csrc/*_pipelined.cu``); each for every element type (f32, bf16) and
#: scheme (W8, W8A8).  ``csrc/tiles.cuh`` lists the same tiles.
GEMM_TILES = (
    (128, 32, 16, 1), (64, 64, 16, 1), (128, 64, 16, 1), (64, 64, 32, 1),
    (128, 32, 16, 2), (64, 64, 16, 2), (128, 32, 16, 3), (64, 64, 16, 3),
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


def conv_default_tile(scheme: str, o: int) -> Tuple[int, int, int]:
    """The conv kernel's default tile: by the output-channel count, over four
    tiles for f32 and two for the INT8 schemes, as before the cache."""
    if scheme == "f32" and o <= 4:
        return (256, 4, 16)
    if scheme == "f32" and o <= 16:
        return (256, 16, 16)
    return (128, 32, 16) if o <= 32 else (64, 64, 16)


_GEMM_TILE_SET = frozenset(GEMM_TILES)
_CONV_TILE_SET = frozenset(CONV_TILES)


def _check_tile(tile, tiles, built, kernels, what):
    if type(tile) is tuple and tile in built:  # the per-call path: no copy
        return tile
    t = tuple(int(v) for v in tile)
    if t not in built:
        what = what() if callable(what) else what
        raise TileError(f"{what}: tile {t} is not instantiated ({kernels} have {list(tiles)})")
    return t


def check_gemm_tile(tile: Sequence[int], what="GEMM") -> Tuple[int, int, int, int]:
    """``tile`` as a tuple if the GEMM kernels are built for it, else raise
    :class:`TileError` naming ``what`` (a tuning key or the wrapper; a
    callable is called only to build the message)."""
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
    cdll.repro_dense_matmul_pipelined.argtypes = [P] * 4 + [I] * 5 + [P, I, P] + [I] * 5 + [P]
    cdll.repro_dense_matmul_pipelined.restype = I
    cdll.repro_ffn_gateup.argtypes = [P, P, P, P, I, I, I, I, I, P, P, I, I, P]
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


def skinny_plan(m: int, n: int, k: int, vec: int) -> Tuple[int, int, int]:
    """``(kchunk, nsplit, tiles)`` of a skinny split-K launch (M <= 8): the
    K chunk per block (at most ``SKINNY_KC``), the number of K splits, and
    the number of output tiles (one counter each).  The splits are chosen
    so that the grid has about ``SKINNY_TARGET_BLOCKS`` blocks."""
    tiles = -(-n // (32 * vec)) * -(-m // SKINNY_MT)
    nsplit = max(-(-SKINNY_TARGET_BLOCKS // tiles), -(-k // SKINNY_KC), 1)
    nsplit = min(nsplit, max(1, -(-k // 64)))  # at least 64 K rows per block
    nsplit = max(nsplit, -(-k // SKINNY_KC))
    kchunk = -(-k // nsplit)
    return kchunk, -(-k // kchunk), tiles
