"""Public wrappers around the port's kernels (a port of ``repro.kernels.ops``
for the ported paths).

These do the layout work so the executor calls one function per op:
leading-batch flattening, the 1x1-conv direct-GEMM fast path, the conv
fallback matrix, the block-sparse matmul's band dispatch, the decoder's
attention and gated-FFN calls, and the INT8 schemes' activation
quantization (W8A8 activations are quantized here, before the kernel, as
the JAX wrappers do, and their scale is folded into the kernel's
per-column rescale).  Each
routes to a kernel wrapper in this package, whose device picks the route
(CPU tensor: plain version; CUDA tensor: the CUDA kernel or an error).

Block sizes not pinned by the caller come from the :class:`TuningCache`,
as in the JAX package: keyed by ``op|dims|dtype|format|mode``, seeded with
the kernels' shape-based default tiles (so nothing sweeps unless asked),
and able to sweep the kernels' instantiated tiles once per key when tuning
is on (``REPRO_TUNE=1`` or :func:`set_tuning`); it persists to JSON
(``REPRO_TUNE_CACHE=path``, ``save`` / ``load``) in the JAX package's
schema.  A ``matmul`` / ``qmatmul`` winner whose fourth field (pipeline
depth) is 2 or more runs the pipelined kernels.

Differences from the JAX wrappers, by design:

* no padding to block multiples -- the CUDA kernels mask ragged edges;
* the cache key's mode field is ``cpu`` (the plain versions) or
  ``sm{major}{minor}`` (the card, ``sm90`` on an H100) instead of
  ``interpret`` / ``hw``, so a TPU winner never steers the card and a card
  winner never the TPU; ``DEFAULTS`` and ``CANDIDATES`` name the CUDA
  kernels' own tiles (``_build.GEMM_TILES`` / ``CONV_TILES``; bf16
  ``matmul`` keys sweep ``_build.BF16_GEMM_TILES``), and a tile
  they are not built for raises (from a pin or a loaded entry) or is
  skipped (in a sweep);
* the bf16 skinny split-K route (M <= 8, decode) stays outside the cache:
  its split is planned from (M, N, K), not from tiles; a pinned tile sends
  such a call to the tiled kernel;
* ``fused_elementwise`` and ``bsr_matmul`` record their keys but never
  sweep: their kernels have one configuration each;
* the conv fallback matrix keeps ``groups`` / ``dilation`` / ``padding`` /
  ``degenerate`` and routes them to the plain version (never to a library
  convolution), counted in ``conv_fallback_total{reason}`` as the JAX
  package counts its ``lax.conv`` route.  Its TPU-only ``vmem`` reason is
  gone: the CUDA kernel tiles its own shared memory at any width;
* ``bsr_matmul``'s bands write into one preallocated output (no concat),
  and an empty band runs the kernel's epilogue-only launch instead of a
  plain-torch epilogue of zeros.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import statistics
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from ..obs import metrics as _metrics
from ..quant.qtensor import fake_quant, quantize_array, scale_tensor
from . import _build
from . import bsr_matmul as _bsr_mod
from . import conv2d as _conv2d_mod
from . import dense_matmul as _dense_mod
from . import dense_matmul_pipelined as _dense_pipe_mod
from . import flash_attention as _flash_mod
from . import fused_elementwise as _fused_mod
from . import fused_ffn as _ffn_mod
from . import quant_matmul as _quant_mod
from . import quant_matmul_pipelined as _quant_pipe_mod
from .conv2d import conv2d_gemm as _conv2d_gemm
from .conv2d import conv_out_hw, conv_pad_hw, conv_padding_token
from .dense_matmul import dense_matmul as _dense_matmul
from .fused_elementwise import fused_elementwise as _fused_elementwise
from .quant_matmul import quant_matmul as _quant_matmul
from .ref import apply_steps_ref, conv2d_ref

__all__ = [
    "matmul",
    "col_matmul",
    "bsr_matmul",
    "qmatmul",
    "conv2d",
    "fused_elementwise",
    "ffn_gateup",
    "attention",
    "conv_out_hw",
    "conv_pad_hw",
    "conv_padding_token",
    "conv_gemm1x1_elected",
    "conv_fallback_reason",
    "conv_fallback_counts",
    "reset_conv_fallbacks",
    "conv_fastpath_counts",
    "reset_conv_fastpaths",
    "kernel_launch_counts",
    "conv_scheme_launch_counts",
    "dense_dtype_launch_counts",
    "reset_kernel_launches",
    "TuneEntry",
    "TuningCache",
    "tuning_cache",
    "set_tuning",
    "device_mode",
]

#: kernel modules by the name their launch count is reported under
_KERNEL_MODULES = {
    "conv2d": _conv2d_mod,
    "dense_matmul": _dense_mod,
    "fused_elementwise": _fused_mod,
    "quant_matmul": _quant_mod,
    "flash_attention": _flash_mod,
    "ffn_gateup": _ffn_mod,
    "bsr_matmul": _bsr_mod,
    "dense_matmul_pipelined": _dense_pipe_mod,
    "quant_matmul_pipelined": _quant_pipe_mod,
}


def kernel_launch_counts() -> Dict[str, int]:
    """CUDA kernel launches per kernel since the last reset (CPU calls that
    take the plain versions launch nothing and count nothing)."""
    return {name: mod.launches for name, mod in _KERNEL_MODULES.items()}


def conv_scheme_launch_counts() -> Dict[str, int]:
    """The conv kernel's launches since the last reset, by scheme (``f32``
    -- channel-pruned included -- ``w8``, ``w8a8``)."""
    return dict(_conv2d_mod.scheme_launches)


def dense_dtype_launch_counts() -> Dict[str, int]:
    """The (tiled) dense-matmul kernel's launches since the last reset, by
    element type (``f32``, ``bf16``)."""
    return dict(_dense_mod.dtype_launches)


def reset_kernel_launches() -> None:
    for mod in _KERNEL_MODULES.values():
        mod.launches = 0
    for counts in (_dense_mod.dtype_launches, _dense_pipe_mod.dtype_launches,
                   _conv2d_mod.scheme_launches):
        for key in counts:
            counts[key] = 0


# --------------------------------------------------------------------------- #
# block-size tuning cache                                                      #
# --------------------------------------------------------------------------- #

#: back-to-back calls timed between one pair of CUDA events in a sweep
SWEEP_CALLS = 5


@dataclasses.dataclass
class TuneEntry:
    blocks: Tuple[int, ...]
    source: str  # "default" | "swept" | "loaded"
    #: a swept candidate's time per call in ms: on the card the stream time
    #: between CUDA events around ``SWEEP_CALLS`` back-to-back calls (after
    #: a warm-up call), median of ``reps``; on the CPU the host time of one
    #: call of the plain version, median of ``reps``
    ms: Optional[float] = None


def device_mode(device: torch.device) -> str:
    """The mode field of a tuning key: ``cpu`` for the plain versions, the
    card's compute capability for CUDA (``sm90`` on an H100)."""
    mode = _MODES.get(device)
    if mode is None:
        dev = torch.device(device)
        if dev.type != "cuda":
            mode = dev.type
        else:
            index = torch.cuda.current_device() if dev.index is None else dev.index
            mode = "sm{}{}".format(*torch.cuda.get_device_capability(index))
        if dev.type != "cuda" or dev.index is not None:  # an index-less cuda may change
            _MODES[device] = mode
    return mode


#: device -> mode, filled on first use (the wrappers ask once per call)
_MODES: Dict[Any, str] = {}


@functools.lru_cache(maxsize=4096)
def _key(op: str, shape: Tuple[int, ...], dtype: Any, fmt: str, mode: str) -> str:
    """The key string (memoized: the wrappers build one per call)."""
    dims = "x".join([str(int(d)) for d in shape])
    return f"{op}|{dims}|{_dtype_name(dtype)}|{fmt}|{mode}"


@functools.lru_cache(maxsize=None)
def _dtype_name(dtype: Any) -> str:
    """The JAX package's dtype names (``float32``, ``bfloat16``, ``int8``)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).split(".")[-1]
    return getattr(dtype, "name", None) or str(dtype)


class TuningCache:
    """Per-shape kernel block-size cache, keyed by
    ``op|dims|dtype|format|mode`` (the JAX package's keys with the port's
    mode field, see :func:`device_mode`).

    ``resolve`` returns cached blocks when the key is known; otherwise, with
    tuning enabled *and* a runner supplied, it sweeps the candidate grid
    once, stores the winner and returns it.  With tuning disabled it records
    and returns the caller's default, so a run never pays a sweep unless
    asked.
    """

    #: the block tuple per op: ``matmul`` / ``qmatmul`` are (block_m,
    #: block_n, block_k, pipeline_depth) -- depth 1 is the tiled kernel,
    #: depth >= 2 the K-slab ring; ``conv2d`` is the conv kernel's (BM, BN,
    #: BK); ``fused_elementwise`` rows per block and ``bsr_matmul`` rows per
    #: M tile, each the one configuration of its kernel.  The wrappers pass
    #: their shape-based default (``_build.default_gemm_tile`` /
    #: ``conv_default_tile``); these are the families' fallbacks.
    DEFAULTS: Dict[str, Tuple[int, ...]] = {
        "matmul": (64, 64, 16, 1),
        "qmatmul": (64, 64, 16, 1),
        "conv2d": (64, 64, 16),
        "fused_elementwise": (4,),
        "bsr_matmul": (8,),
    }
    #: the sweep grids: exactly the tiles the CUDA kernels are built for
    CANDIDATES: Dict[str, Tuple[Tuple[int, ...], ...]] = {
        "matmul": _build.GEMM_TILES,
        "qmatmul": _build.GEMM_TILES,
        "conv2d": _build.CONV_TILES,
        "fused_elementwise": ((4,),),
        "bsr_matmul": ((8,),),
    }
    #: the grids of families whose bf16 instances run other kernels: bf16
    #: ``matmul`` sweeps the tensor-core kernel's own tiles (same keys, the
    #: dtype field tells them apart)
    BF16_CANDIDATES: Dict[str, Tuple[Tuple[int, ...], ...]] = {
        "matmul": _build.BF16_GEMM_TILES,
    }

    @classmethod
    def candidates(cls, op: str, dtype: Any) -> Tuple[Tuple[int, ...], ...]:
        """The sweep grid of ``op`` for operands of ``dtype``."""
        if _dtype_name(dtype) == "bfloat16" and op in cls.BF16_CANDIDATES:
            return cls.BF16_CANDIDATES[op]
        return cls.CANDIDATES[op]

    def __init__(self, enabled: Optional[bool] = None, path: Optional[str] = None):
        env = os.environ.get("REPRO_TUNE")
        self.enabled = (env not in (None, "0", "false", "False")) if enabled is None else enabled
        self.entries: Dict[str, TuneEntry] = {}
        self.sweeps = 0  # number of grid sweeps actually executed
        #: restrict sweeping to these op families (None = all); lookups and
        #: defaults still serve every family (the tune CLI's --ops filter)
        self.ops_filter: Optional[frozenset] = None
        #: per-key-family resolve accounting: hits (cached winner returned),
        #: misses (no usable entry -- default recorded or sweep triggered),
        #: sweeps (candidate grids actually timed)
        self.stats: Dict[str, Dict[str, int]] = {}
        self.path = path or os.environ.get("REPRO_TUNE_CACHE")
        if self.path and os.path.exists(self.path):
            try:
                self.load(self.path)
            except (json.JSONDecodeError, KeyError, TypeError, OSError) as e:
                # a stale/corrupt cache must never brick the import; sweeps
                # or defaults will repopulate it on the next save
                import warnings

                warnings.warn(f"ignoring unreadable tuning cache {self.path}: {e}")

    # -- keying -------------------------------------------------------------- #
    @staticmethod
    def key_nd(op: str, shape: Sequence[int], dtype: Any, fmt: str, mode: str) -> str:
        """Key over an arbitrary-rank shape signature: the GEMM family keys
        on ``MxNxK``, ``conv2d`` on ``NxCxHxWxOxKHxKWxS`` (batch, contracted
        input channels, spatial dims, output channels, filter taps, stride).
        The plain versions' timings (``cpu``) measure the host, not the
        card: they never shadow a card's winner, nor one card's another's."""
        return _key(op, tuple(shape), dtype, fmt, mode)

    @staticmethod
    def key(op: str, m: int, n: int, k: int, dtype: Any, fmt: str, mode: str) -> str:
        return TuningCache.key_nd(op, (m, n, k), dtype, fmt, mode)

    # -- lookup / sweep ------------------------------------------------------ #
    def lookup(self, op, m, n, k, dtype, fmt, mode) -> Optional[Tuple[int, ...]]:
        return self.lookup_nd(op, (m, n, k), dtype, fmt, mode)

    def lookup_nd(self, op, shape, dtype, fmt, mode) -> Optional[Tuple[int, ...]]:
        e = self.entries.get(self.key_nd(op, shape, dtype, fmt, mode))
        return None if e is None else e.blocks

    def resolve(
        self,
        op: str,
        m: int,
        n: int,
        k: int,
        dtype: Any,
        fmt: str,
        mode: str,
        runner: Optional[Callable[..., Any]] = None,
        reps: int = 3,
        default: Optional[Tuple[int, ...]] = None,
    ) -> Tuple[int, ...]:
        return self.resolve_nd(op, (m, n, k), dtype, fmt, mode, runner, reps, default)

    def resolve_nd(
        self,
        op: str,
        shape: Sequence[int],
        dtype: Any,
        fmt: str,
        mode: str,
        runner: Optional[Callable[..., Any]] = None,
        reps: int = 3,
        default: Optional[Tuple[int, ...]] = None,
    ) -> Tuple[int, ...]:
        """Cached winner for the key if one exists; else sweep (tuning
        enabled + runner + op not excluded by ``ops_filter``) or fall back
        to ``default`` (the caller's shape-aware seed) or the op family's
        static ``DEFAULTS`` entry.  A candidate whose runner raises
        ``_build.TileError`` (a tile the kernels lack for this call) is
        skipped; any other error propagates."""
        key = _key(op, tuple(shape), dtype, fmt, mode)
        stat = self.stats.get(op)
        if stat is None:
            stat = self.stats[op] = {"hits": 0, "misses": 0, "sweeps": 0}
        hit = self.entries.get(key)
        can_sweep = (
            self.enabled
            and runner is not None
            and (self.ops_filter is None or op in self.ops_filter)
        )
        # seeded-default entries are placeholders, not measurements: re-tune
        # them the first time a sweep is actually possible
        if hit is not None and not (can_sweep and hit.source == "default"):
            stat["hits"] += 1
            return hit.blocks
        stat["misses"] += 1
        if can_sweep:
            best, best_ms = None, float("inf")
            for cand in self.candidates(op, dtype):
                try:
                    ms = _time_candidate(runner, cand, reps, mode != "cpu")
                except _build.TileError:
                    continue  # the kernels lack this tile for this call
                if ms < best_ms:
                    best, best_ms = cand, ms
            self.sweeps += 1
            stat["sweeps"] += 1
            if best is not None:
                self.entries[key] = TuneEntry(best, "swept", best_ms)
                return best
        default = default or self.DEFAULTS[op]
        self.entries[key] = TuneEntry(default, "default")
        return default

    # -- persistence --------------------------------------------------------- #
    def save(self, path: Optional[str] = None) -> str:
        path = path or self.path
        if not path:
            raise ValueError("no cache path given (arg or REPRO_TUNE_CACHE)")
        payload = {
            "version": 1,
            # defaults are placeholders (never measured): persisting them
            # would block future sweeps of those shapes in other processes
            "entries": {
                k: {"blocks": list(e.blocks), "source": e.source, "ms": e.ms}
                for k, e in self.entries.items()
                if e.source != "default"
            },
        }
        # crash-safe: temp file in the target directory, fsync, atomic
        # rename -- a reader never sees a truncated JSON and an interrupted
        # save leaves the previous file intact
        from ..utils.fileio import atomic_write_json

        return atomic_write_json(path, payload, prefix=".tune-")

    def load(self, path: str) -> "TuningCache":
        with open(path) as f:
            payload = json.load(f)
        for k, e in payload["entries"].items():
            self.entries[k] = TuneEntry(tuple(e["blocks"]), "loaded", e.get("ms"))
        return self

    def clear(self) -> None:
        self.entries.clear()
        self.sweeps = 0
        self.stats.clear()

    def stats_report(self) -> str:
        """Per-key-family resolve accounting (hits / misses / sweeps) --
        printed by the ``launch.tune`` CLI after a pre-warm pass."""
        lines = ["family,hits,misses,sweeps"]
        for op in sorted(self.stats):
            s = self.stats[op]
            lines.append(f"{op},{s['hits']},{s['misses']},{s['sweeps']}")
        return "\n".join(lines)

    def report(self) -> str:
        lines = ["op,shape,dtype,format,mode,blocks,source,ms"]
        for k in sorted(self.entries):
            op, shape, dt, fmt, mode = k.split("|")
            e = self.entries[k]
            ms = "" if e.ms is None else f"{e.ms:.3f}"
            lines.append(
                f"{op},{shape},{dt},{fmt},{mode},{'x'.join(map(str, e.blocks))},{e.source},{ms}"
            )
        return "\n".join(lines)


def _time_candidate(runner: Callable[..., Any], cand: Tuple[int, ...], reps: int,
                    cuda: bool) -> float:
    """ms per call of ``runner(*cand)`` (see :attr:`TuneEntry.ms`): on the
    card the kernel's stream time, not the host's ~0.1 ms of wrapper work
    per call, as long as the kernel outlasts it."""
    runner(*cand)  # warm-up: the first launch may build the kernels
    ts = []
    if cuda:
        torch.cuda.synchronize()
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(SWEEP_CALLS):
                runner(*cand)
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) / SWEEP_CALLS)
        return float(statistics.median(ts))
    for _ in range(reps):
        t0 = time.perf_counter()
        runner(*cand)
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(statistics.median(ts))


_TUNING = TuningCache()


def tuning_cache() -> TuningCache:
    """The process-wide block-size cache the wrappers consult when block
    sizes are not pinned."""
    return _TUNING


def set_tuning(enabled: bool) -> TuningCache:
    _TUNING.enabled = enabled
    return _TUNING


def _blocks4(blocks: Sequence[int]) -> Tuple[int, int, int, int]:
    """Normalize a matmul-family blocks tuple: legacy 3-field entries (from
    pre-pipeline cache files) mean the tiled kernel (pipeline depth 1)."""
    if len(blocks) == 4:
        return tuple(blocks)
    return (*(int(b) for b in blocks[:3]), 1)


def _conv_blocks3(blocks: Sequence[int]) -> Tuple[int, int, int]:
    """Normalize a conv2d blocks tuple: a 2-field entry (BM, BN) means the
    K slab every conv tile had before the tile became tunable (16)."""
    if len(blocks) == 3:
        return tuple(blocks)
    return (*(int(b) for b in blocks[:2]), 16)


def _gemm_tile(op: str, m: int, n: int, k: int, dtype: Any, fmt: str, mode: str,
               pins: Tuple[Optional[int], ...], runner) -> Tuple[int, int, int, int]:
    """The (block_m, block_n, block_k, depth) of a ``matmul`` / ``qmatmul``
    call, as the JAX wrappers pick it: nothing pinned -> the cache (the
    shape-based default as its seed), with a ``pipeline`` pin overriding
    the depth; block sizes partially pinned -> the rest from the default,
    never from the cache (a winner for the free dims was timed with other
    pins).  A tile the kernels lack raises, naming the key."""
    block_m, block_n, block_k, pipeline = pins
    default = _build.default_gemm_tile(m, n, dtype)
    if block_m is None and block_n is None and block_k is None:
        tile = _blocks4(_TUNING.resolve(op, m, n, k, dtype, fmt, mode, runner, default=default))
        if pipeline is not None:
            tile = (*tile[:3], pipeline)
    else:
        tile = (block_m or default[0], block_n or default[1], block_k or default[2],
                pipeline or 1)
    return _build.check_gemm_tile(tile, lambda: TuningCache.key(op, m, n, k, dtype, fmt, mode),
                                  dtype)


def _one_config(op: str, m: int, n: int, k: int, dtype: Any, fmt: str, device) -> None:
    """Record the key of a kernel with one configuration (no runner: it
    never sweeps), and raise if a loaded entry names another."""
    mode = device_mode(device)
    blocks = tuple(_TUNING.resolve(op, m, n, k, dtype, fmt, mode))
    if blocks not in TuningCache.CANDIDATES[op]:
        raise _build.TileError(f"{TuningCache.key(op, m, n, k, dtype, fmt, mode)}: blocks "
                               f"{blocks} are not the {op} kernel's "
                               f"{TuningCache.CANDIDATES[op][0]}")


@functools.lru_cache(maxsize=1024)
def _conv_fmt(fmt: str, scheme: str, padding, n_steps: int, n_sides: int) -> str:
    """A conv key's format: SAME (canonical) keys bare, VALID / explicit
    pads suffixed -- same dims, another output geometry never shares a
    winner -- then the epilogue suffix."""
    out = f"{fmt}+{scheme}" + conv_padding_token(padding)
    return f"{out}+e{n_steps}s{n_sides}" if n_steps else out


def _epilogue_fmt(fmt: str, epilogue: Sequence, n_sides: int) -> str:
    """An epilogue'd call streams extra per-tile sides: never let its
    winner alias the plain call's."""
    return f"{fmt}+e{len(epilogue)}s{n_sides}" if epilogue else fmt


# --------------------------------------------------------------------------- #
# conv routing counters (metrics-registry views, as in the JAX package)        #
# --------------------------------------------------------------------------- #

_CONV_FALLBACK_METRIC = "conv_fallback_total"
_CONV_FASTPATH_METRIC = "conv_fastpath_total"


def conv_fallback_counts() -> Dict[str, int]:
    """reason -> count of convs routed to the plain version."""
    counts = _metrics.registry().label_counts(_CONV_FALLBACK_METRIC, "reason")
    return {k: int(v) for k, v in counts.items()}


def reset_conv_fallbacks() -> None:
    _metrics.registry().reset(_CONV_FALLBACK_METRIC)


def conv_fastpath_counts() -> Dict[str, int]:
    """scheme -> count of convs elected onto the 1x1 direct-GEMM path."""
    counts = _metrics.registry().label_counts(_CONV_FASTPATH_METRIC, "scheme")
    return {k: int(v) for k, v in counts.items()}


def reset_conv_fastpaths() -> None:
    _metrics.registry().reset(_CONV_FASTPATH_METRIC)


# --------------------------------------------------------------------------- #
# GEMM family                                                                  #
# --------------------------------------------------------------------------- #


def _dense_call(x2, w, bias, sides2, activation, epilogue, tile):
    """One dense GEMM launch: the tiled kernel (depth 1), the ring kernel
    (depth >= 2), or -- ``tile`` None -- the kernel's own choice (the bf16
    skinny route)."""
    kw = dict(activation=activation, epilogue=epilogue)
    if tile is None:
        return _dense_matmul(x2, w, bias, *sides2, **kw)
    bm, bn, bk, depth = tile
    if depth >= 2:
        return _dense_pipe_mod.dense_matmul_pipelined(
            x2, w, bias, *sides2, block_m=bm, block_n=bn, block_k=bk, depth=depth, **kw)
    return _dense_matmul(x2, w, bias, *sides2, block_m=bm, block_n=bn, block_k=bk, **kw)


def matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    activation: Optional[str] = None,
    epilogue: Sequence[Tuple] = (),
    epilogue_sides: Sequence[torch.Tensor] = (),
    block_m: Optional[int] = None,
    block_n: Optional[int] = None,
    block_k: Optional[int] = None,
    pipeline: Optional[int] = None,
    _format: str = "dense",
) -> torch.Tensor:
    """``epilogue(act(x @ w + bias))`` for arbitrary leading batch dims
    through the dense-matmul kernel.  ``epilogue_sides`` are shaped like the
    output (or its flattened ``[M, N]`` view).

    Block sizes left as ``None`` are resolved through the tuning cache under
    ``matmul|MxNxK|{dtype}|{_format}[+e{steps}s{sides}]|{mode}`` (cached
    winner, else the shape-based default; a one-off sweep when tuning is
    on).  The tuple's fourth field is the pipeline depth: 1 = the tiled
    kernel, >= 2 = the K-slab ring (:mod:`.dense_matmul_pipelined`);
    ``pipeline`` pins it.  bf16 calls with M <= 8 and nothing pinned take
    the skinny route, outside the cache."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    m, k = x2.shape
    n = w.shape[1]
    sides2 = []
    for s in epilogue_sides:
        if tuple(s.shape) not in ((*lead, n), (m, n)):
            raise ValueError(f"matmul: side {tuple(s.shape)} vs output {(*lead, n)}")
        sides2.append(s.reshape(m, n).contiguous())
    w = w.contiguous()
    epilogue = tuple(tuple(s) for s in epilogue)
    pins = (block_m, block_n, block_k, pipeline)
    tile = None
    if x2.dtype != torch.bfloat16 or m > _build.SKINNY_MT or pins != (None,) * 4:
        runner = None
        if _TUNING.enabled:  # a tile the kernels lack raises TileError: the sweep skips it
            def runner(bm, bn, bk, depth=1):
                t = (bm, bn, bk, depth if pipeline is None else pipeline)
                return _dense_call(x2, w, bias, sides2, activation, epilogue, t)

        fmt = _epilogue_fmt(_format, epilogue, len(sides2))
        tile = _gemm_tile("matmul", m, n, k, x2.dtype, fmt, device_mode(x2.device), pins, runner)
    out = _dense_call(x2, w, bias, sides2, activation, epilogue, tile)
    return out.reshape(*lead, n)


def col_matmul(
    x: torch.Tensor,
    values: torch.Tensor,
    kept: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    activation: Optional[str] = None,
    epilogue: Sequence[Tuple] = (),
    epilogue_sides: Sequence[torch.Tensor] = (),
    block_m: Optional[int] = None,
    block_n: Optional[int] = None,
    block_k: Optional[int] = None,
    pipeline: Optional[int] = None,
) -> torch.Tensor:
    """Column-pruned ``act(x @ W + bias)``: static input gather + the
    strictly smaller dense GEMM.  ``values [K_kept, N]``.  Tuned under its
    own ``colcompact`` key (the gathered K differs from the dense
    layer's)."""
    return matmul(
        x.index_select(-1, kept), values, bias, activation=activation,
        epilogue=epilogue, epilogue_sides=epilogue_sides, block_m=block_m, block_n=block_n,
        block_k=block_k, pipeline=pipeline, _format="colcompact",
    )


def bsr_matmul(
    x: torch.Tensor,
    values: torch.Tensor,
    block_rows: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    activation: Optional[str] = None,
    epilogue: Sequence[Tuple] = (),
    epilogue_sides: Sequence[torch.Tensor] = (),
    bands: Optional[Sequence[Tuple[int, int, int]]] = None,
) -> torch.Tensor:
    """Block-sparse ``epilogue(act(x @ W + bias))`` over PBCSR-packed weights
    for arbitrary leading batch dims.

    ``bands`` (from the reorder pass): ``(start, stop, count)`` over output
    block-columns, in order and covering all of them; one kernel launch per
    band with the exact trip count ``count`` -- an empty band (``count ==
    0``) launches too and outputs only the epilogue of a zero accumulator.
    Without bands, one launch over every column with all ``S`` steps.  Each
    launch writes its band's columns of one output (no concat) and reads
    the bias and side operands at those columns.  ``epilogue`` is the
    :func:`matmul` step program, run on the f32 accumulator in each band's
    launch.  The plain route (CPU tensors) walks the same band loop."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    m = x2.shape[0]
    nb, s, _, bn = values.shape
    n = nb * bn
    sides2 = []
    for sv in epilogue_sides:
        if tuple(sv.shape) not in ((*lead, n), (m, n)):
            raise ValueError(f"bsr_matmul: side {tuple(sv.shape)} vs output {(*lead, n)}")
        sides2.append(sv.reshape(m, n).contiguous())
    bands = tuple(tuple(int(v) for v in b) for b in bands) if bands else ((0, nb, s),)
    covered = 0
    for start, stop, _ in bands:
        if start != covered or stop < start:
            raise ValueError(f"bsr_matmul: bands {bands} do not tile {nb} block-columns")
        covered = stop
    if covered != nb:
        raise ValueError(f"bsr_matmul: bands {bands} do not tile {nb} block-columns")
    epilogue = tuple(tuple(st) for st in epilogue)
    _one_config("bsr_matmul", m, n, x2.shape[1], x2.dtype,
                _epilogue_fmt("pbcsr", epilogue, len(sides2)), x2.device)
    out = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    for band in bands:
        if band[1] > band[0]:
            _bsr_mod.bsr_matmul(
                x2, values, block_rows, bias, *sides2, activation=activation,
                epilogue=epilogue, band=band, out=out,
            )
    return out.reshape(*lead, n)


def _quant_call(x2, w_q, ws, bias, sides2, activation, epilogue, tile):
    """One quant GEMM launch: the tiled kernel (depth 1) or the ring kernel
    (depth >= 2)."""
    bm, bn, bk, depth = tile
    kw = dict(activation=activation, epilogue=epilogue, block_m=bm, block_n=bn, block_k=bk)
    if depth >= 2:
        return _quant_pipe_mod.quant_matmul_pipelined(x2, w_q, ws, bias, *sides2, depth=depth,
                                                      **kw)
    return _quant_matmul(x2, w_q, ws, bias, *sides2, **kw)


def qmatmul(
    x: torch.Tensor,
    w_q: torch.Tensor,
    w_scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    x_scale: Optional[float] = None,
    activation: Optional[str] = None,
    epilogue: Sequence[Tuple] = (),
    epilogue_sides: Sequence[torch.Tensor] = (),
    block_m: Optional[int] = None,
    block_n: Optional[int] = None,
    block_k: Optional[int] = None,
    pipeline: Optional[int] = None,
    _format: str = "dense",
) -> torch.Tensor:
    """Quantized ``epilogue(act((x @ w_q) * scales + bias))`` for arbitrary
    leading batch dims through the INT8 matmul kernel.

    ``w_q [K, N]`` int8 with per-output-channel ``w_scale [N]`` f32.  With
    ``x_scale`` (the calibrated static activation scale, a Python float) the
    f32 activations are quantized to int8 here and the kernel sums int8 x
    int8 products in int32 (**W8A8**); the activation scale is folded into
    the per-column rescale, ``w_scale * x_scale`` in f32.  Without it the
    activations stay f32 and only the weights are int8 (**W8**).

    Tuned under the ``qmatmul`` key family, whose format carries the
    storage format and the scheme (``dense+w8a8``, ``colcompact+w8``, ...)
    plus the ``+e{steps}s{sides}`` epilogue suffix; block pins and
    ``pipeline`` as in :func:`matmul`."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    m, k = x2.shape
    n = w_q.shape[1]
    sides2 = []
    for s in epilogue_sides:
        if tuple(s.shape) not in ((*lead, n), (m, n)):
            raise ValueError(f"qmatmul: side {tuple(s.shape)} vs output {(*lead, n)}")
        sides2.append(s.reshape(m, n).contiguous())
    ws = w_scale.float()
    if x_scale is not None:
        s = scale_tensor(x_scale, x2)
        x2 = quantize_array(x2, s)
        ws = ws * s
    w_q, ws = w_q.contiguous(), ws.contiguous()
    epilogue = tuple(tuple(s) for s in epilogue)
    scheme = "w8" if x_scale is None else "w8a8"
    runner = None
    if _TUNING.enabled:  # a tile the kernels lack raises TileError: the sweep skips it
        def runner(bm, bn, bk, depth=1):
            t = (bm, bn, bk, depth if pipeline is None else pipeline)
            return _quant_call(x2, w_q, ws, bias, sides2, activation, epilogue, t)

    fmt = _epilogue_fmt(f"{_format}+{scheme}", epilogue, len(sides2))
    tile = _gemm_tile("qmatmul", m, n, k, x2.dtype, fmt, device_mode(x2.device),
                      (block_m, block_n, block_k, pipeline), runner)
    out = _quant_call(x2, w_q, ws, bias, sides2, activation, epilogue, tile)
    return out.reshape(*lead, n)


# --------------------------------------------------------------------------- #
# conv2d                                                                       #
# --------------------------------------------------------------------------- #


def conv_gemm1x1_elected(kh: int, kw: int, groups: int, padding, c: int) -> bool:
    """True when a conv lowers through the 1x1 direct-GEMM fast path: unit
    taps, ungrouped, live input channels, and padding that adds no border
    (SAME == VALID for 1x1 taps; explicit pads must be all-zero)."""
    if kh != 1 or kw != 1 or groups != 1 or c <= 0:
        return False
    if isinstance(padding, str):
        return padding in ("SAME", "VALID")
    try:
        (a, b), (c2, d) = padding
        return int(a) == int(b) == int(c2) == int(d) == 0
    except (TypeError, ValueError):
        return False


def conv_fallback_reason(
    c: int, h: int, w: int, kh: int, kw: int, stride: int, padding,
    *, groups: int = 1, dilation: int = 1,
) -> Optional[str]:
    """The conv fallback matrix: the reason a conv cannot take the kernel
    (``groups`` / ``dilation`` / ``padding`` / ``degenerate``), or None.
    ``c`` is the contracted channel count."""
    if groups != 1:
        return "groups"
    if dilation != 1:
        return "dilation"
    if not isinstance(padding, str):
        try:
            (a, b), (c2, d) = padding
            if min(int(a), int(b), int(c2), int(d)) < 0:
                return "padding"  # lax allows negative (cropping) pads; the kernel does not
        except (TypeError, ValueError):
            return "padding"
    try:
        oh, ow = conv_out_hw(h, w, kh, kw, stride, padding)
    except (TypeError, ValueError):
        return "padding"
    if oh < 1 or ow < 1:
        return "degenerate"
    return None


def _conv2d_fallback(x, w, bias, *, stride, padding, kept, w_scale, x_scale, groups,
                     dilation, activation, epilogue, sides):
    """The plain route for configs outside the kernel's matrix -- the same
    math as the reference handlers (channel gather, dequant / fake-quant for
    int8 weights, conv, step tail)."""
    if kept is not None:
        x = x.index_select(1, kept)
    if w.dtype == torch.int8:
        w = w.float() * w_scale.float()[:, None, None, None]
        if x_scale is not None:
            x = fake_quant(x.float(), x_scale)
    y = conv2d_ref(x, w, bias, stride=stride, padding=padding, groups=groups,
                   dilation=dilation, activation=activation, out_dtype=torch.float32)
    if epilogue:
        y = apply_steps_ref(y, epilogue, [s.float() for s in sides])
    return y.to(x.dtype)


def _conv2d_1x1_gemm(x, w, bias, *, stride, kept, w_scale, x_scale, activation, epilogue,
                     sides, fmt, block_m=None, block_n=None, block_k=None, pipeline=None):
    """The 1x1 direct-GEMM fast path: a unit-tap conv with no border padding
    is ``y[n, :, i, j] = W @ x[n, :, i*s, j*s]`` -- a plain GEMM over the
    ``N*OH*OW`` pixel axis.  NCHW is permuted to pixel-major ``[P, C]`` (the
    stride subsamples the grid first), the OIHW filter collapses to
    ``[C, O]``, and bias / activation / epilogue with its side operands ride
    the dense-matmul kernel (f32) or the quant-matmul kernel (int8 weights,
    with the conv's ``w_scale`` / ``x_scale``).  The permutes around it are
    plain torch.  Keyed under the ``conv1x1.{fmt}`` matmul-family format,
    never aliasing a plain GEMM's winner; the pins go to the GEMM."""
    if kept is not None:
        x = x.index_select(1, kept)
    if stride > 1:
        x = x[:, :, ::stride, ::stride]
    nb, c, oh, ow = x.shape
    o = w.shape[0]
    if w.shape[1] != c:
        raise ValueError(f"conv2d: w {tuple(w.shape)} vs {c} live input channels")
    for s in sides:
        if tuple(s.shape) != (nb, o, oh, ow):
            raise ValueError(f"conv2d: side {tuple(s.shape)} != {(nb, o, oh, ow)}")
    xm = x.permute(0, 2, 3, 1).reshape(nb * oh * ow, c)
    wm = w.reshape(o, c).t()
    sm = [s.permute(0, 2, 3, 1).reshape(nb * oh * ow, o) for s in sides]
    kw = dict(activation=activation, epilogue=epilogue, epilogue_sides=sm, block_m=block_m,
              block_n=block_n, block_k=block_k, pipeline=pipeline, _format=f"conv1x1.{fmt}")
    if w.dtype == torch.int8:
        y = qmatmul(xm, wm, w_scale, bias, x_scale=x_scale, **kw)
    else:
        y = matmul(xm, wm, bias, **kw)
    return y.reshape(nb, oh, ow, o).permute(0, 3, 1, 2).contiguous()


def conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    stride: int = 1,
    padding="SAME",
    kept: Optional[torch.Tensor] = None,
    w_scale: Optional[torch.Tensor] = None,
    x_scale: Optional[float] = None,
    groups: int = 1,
    dilation: int = 1,
    activation: Optional[str] = None,
    epilogue: Sequence[Tuple] = (),
    epilogue_sides: Sequence[torch.Tensor] = (),
    block_m: Optional[int] = None,
    block_n: Optional[int] = None,
    block_k: Optional[int] = None,
    pipeline: Optional[int] = None,
    _format: Optional[str] = None,
) -> torch.Tensor:
    """``epilogue(act(conv2d(x, w) + bias))``: ``x [N, C, H, W]`` NCHW,
    ``w [O, C', kh, kw]`` OIHW, SAME/VALID/explicit ``padding``, square
    ``stride``; ``kept`` (live input-channel indices of a channel-pruned
    conv) makes the kernel contract only ``C' = len(kept)`` channels.

    Scheme, from the operands: f32 ``w`` is **f32**; int8 ``w`` with
    ``w_scale [O]`` is **W8** (f32 activations, int8 filters), and with a
    calibrated ``x_scale`` too **W8A8** (activations quantized to int8
    here, int32 sums in the kernel, ``x_scale`` folded into the rescale).
    Raises for int8 weights without ``w_scale`` and for ``x_scale`` with f32
    weights.

    Routing, in order: the **1x1 fast path** (:func:`conv_gemm1x1_elected`,
    counted per scheme in :func:`conv_fastpath_counts`) lowers to
    :func:`matmul` / :func:`qmatmul` (keyed ``conv1x1.{fmt}``, ``pipeline``
    passed on); pinning any conv block size opts back into the conv
    kernel, as in the JAX package; the **fallback matrix**
    (:func:`conv_fallback_reason`) routes to the plain version (dequantized
    filters, fake-quantized activations for W8A8), counted in
    :func:`conv_fallback_counts`; everything else runs the implicit-GEMM
    conv kernel, whose tile ``(block_m, block_n, block_k)`` -- output pixels
    x output channels x K slab -- left as ``None`` resolves through the
    tuning cache under
    ``conv2d|NxCxHxWxOxKHxKWxS|{dtype}|{fmt}+{scheme}[+valid|+p..][+e..s..]|{mode}``
    (``fmt`` is ``_format``, else ``channelcompact`` with ``kept``, else
    ``dense``), seeded with the default tile for the scheme and ``O``.  The
    conv kernel has no pipelined variant: ``pipeline >= 2`` raises there."""
    epilogue = tuple(tuple(s) for s in epilogue)
    sides = tuple(epilogue_sides)
    nb, c_in, h, w_in = x.shape
    o, _, kh, kw_ = w.shape
    is_q = w.dtype == torch.int8
    if is_q and w_scale is None:
        raise ValueError("int8 conv weights need w_scale")
    if x_scale is not None and not is_q:
        raise ValueError("x_scale (W8A8) requires int8 weights")
    scheme = "f32" if not is_q else ("w8a8" if x_scale is not None else "w8")
    fmt = _format or ("channelcompact" if kept is not None else "dense")
    c_live = int(kept.shape[0]) if kept is not None else c_in
    pinned = (block_m, block_n, block_k) != (None, None, None)
    if not pinned and conv_gemm1x1_elected(kh, kw_, groups, padding, c_live):
        _metrics.registry().counter(_CONV_FASTPATH_METRIC, scheme=scheme).inc()
        return _conv2d_1x1_gemm(
            x, w, bias, stride=stride, kept=kept, w_scale=w_scale, x_scale=x_scale,
            activation=activation, epilogue=epilogue, sides=sides, fmt=fmt, pipeline=pipeline,
        )
    if pipeline is not None and pipeline >= 2:
        raise _build.TileError(f"conv2d: pipeline {pipeline}: the conv kernel has no "
                               "pipelined variant")
    reason = conv_fallback_reason(
        c_live, h, w_in, kh, kw_, stride, padding, groups=groups, dilation=dilation,
    )
    if reason is not None:
        _metrics.registry().counter(_CONV_FALLBACK_METRIC, reason=reason).inc()
        return _conv2d_fallback(
            x, w, bias, stride=stride, padding=padding, kept=kept, w_scale=w_scale,
            x_scale=x_scale, groups=groups, dilation=dilation, activation=activation,
            epilogue=epilogue, sides=sides,
        )
    ws = None
    if is_q:
        ws = w_scale.float()
        if scheme == "w8a8":
            s = scale_tensor(x_scale, x)
            x = quantize_array(x, s)
            ws = ws * s
    x, w = x.contiguous(), w.contiguous()
    sides = tuple(s.contiguous() for s in sides)
    ws = None if ws is None else ws.contiguous()

    def run(bm, bn, bk):
        return _conv2d_gemm(x, w, bias, *sides, ws=ws, kept=kept, stride=stride,
                            padding=padding, activation=activation, epilogue=epilogue,
                            block_m=bm, block_n=bn, block_k=bk)

    default = _build.conv_default_tile(scheme, o)
    mode = device_mode(x.device)
    shape = (nb, c_live, h, w_in, o, kh, kw_, stride)
    pads = padding if isinstance(padding, str) else tuple(tuple(p) for p in padding)
    fmtkey = _conv_fmt(fmt, scheme, pads, len(epilogue), len(sides))
    if pinned:
        # partially pinned: the rest from the default, never from the cache
        tile = (block_m or default[0], block_n or default[1], block_k or default[2])
    elif c_live == 0:
        # every input channel pruned: nothing to contract, nothing to tune
        # (the JAX wrapper returns before its cache too)
        tile = default
    else:
        tile = _conv_blocks3(_TUNING.resolve_nd(
            "conv2d", shape, x.dtype, fmtkey, mode, run if _TUNING.enabled else None,
            default=default,
        ))
    return run(*_build.check_conv_tile(
        tile, lambda: TuningCache.key_nd("conv2d", shape, x.dtype, fmtkey, mode)))


# --------------------------------------------------------------------------- #
# fused elementwise                                                            #
# --------------------------------------------------------------------------- #


def fused_elementwise(
    x: torch.Tensor,
    sides: Sequence[torch.Tensor] = (),
    steps: Sequence[Tuple] = (),
    norm_params: Sequence[Tuple[torch.Tensor, torch.Tensor]] = (),
) -> torch.Tensor:
    """Run a fused elementwise step program over ``x`` in one kernel pass.
    ``x`` has any leading batch dims; steps operate on the flattened
    ``[M, D]`` view (D = last dim, the layer-norm axis); ``sides`` match
    ``x``'s shape exactly; ``norm_params`` is one ``(scale[D], bias[D])``
    pair per ``("norm", slot, eps)`` step.  The key ``fused_elementwise|
    MxDxn_steps|{dtype}|ew+s{sides}n{norms}|{mode}`` is recorded as the JAX
    wrapper records it; the kernel has one configuration, so it never
    sweeps."""
    d = x.shape[-1]
    for s in sides:
        if s.shape != x.shape:
            raise ValueError(f"fused_elementwise: side {tuple(s.shape)} != {tuple(x.shape)}")
    x2 = x.reshape(-1, d).contiguous()
    s2 = [s.reshape(-1, d).contiguous() for s in sides]
    _one_config("fused_elementwise", x2.shape[0], d, len(steps), x2.dtype,
                f"ew+s{len(sides)}n{len(norm_params)}", x2.device)
    y = _fused_elementwise(x2, s2, tuple(tuple(s) for s in steps), tuple(norm_params))
    return y.reshape(x.shape)


# --------------------------------------------------------------------------- #
# decoder: gated FFN and attention                                             #
# --------------------------------------------------------------------------- #


def ffn_gateup(
    x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, *, activation: str = "silu"
) -> torch.Tensor:
    """Fused ``act(x @ w_gate) * (x @ w_up)`` for arbitrary leading batch dims
    (no padding: the kernel masks ragged edges)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    out = _ffn_mod.ffn_gateup(
        x2, w_gate.contiguous(), w_up.contiguous(), activation=activation
    )
    return out.reshape(*lead, w_gate.shape[1])


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_lengths: Optional[torch.Tensor] = None,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Flash attention over ``q [B, H, Sq, d]`` and ``k / v [B, G, Skv, d]``
    (``G`` divides ``H``; ``G == H`` is plain multi-head attention).
    ``kv_lengths [B]`` masks each row to its valid KV prefix -- the paged-KV
    path, where Skv is the gathered page span, not the live length.  Unlike
    the JAX wrapper nothing is padded to block multiples (the kernel masks
    ragged edges), so non-causal attention without lengths takes any
    shape.  The result on every row equals the JAX wrapper's on its valid
    rows."""
    return _flash_mod.flash_attention(q, k, v, kv_lengths, causal=causal, scale=scale)
