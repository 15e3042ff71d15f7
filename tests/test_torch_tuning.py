"""The port's block-size ``TuningCache`` and the wrappers that consult it, on
the CPU: every case of ``tests/test_tuning_cache.py`` ported to the port's
cache (round trips, dropped defaults, corrupt or missing files, mode
separation, format / scheme axes, loaded entries blocking sweeps, legacy
tuples, ``ops_filter``, ``stats_report``, interrupted and concurrent
saves); files crossing between the two packages; the keys the port's
plans resolve against the JAX package's for the same numpy-seeded graphs;
and pinned tiles and pipeline depths through ``matmul`` / ``qmatmul`` /
``conv2d``.

On the CPU every wrapper takes its kernel's plain version, which ignores
the tile, so a pinned call must give the unpinned result exactly; it is
held to the JAX package's ``matmul_ref`` / ``qmatmul_ref`` at rtol = atol =
1e-5 (f32 sums in another order), and W8A8 to an exact integer reference.
The JAX package's own ``pipeline >= 2`` path cannot run under the installed
jax (``ROADMAP.md`` C), so the pipelined tiles are held to the references.
"""

import json
import os
import re
import subprocess
import sys
import threading
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_quant import quant_case

from repro.core.graph import compile_plan as jcompile_plan
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ops import TuneEntry as JTuneEntry
from repro.kernels.ops import TuningCache as JTuningCache
from repro_torch.core.graph import compile_plan
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops
from repro_torch.kernels.ops import TuneEntry, TuningCache
from repro_torch.models import cnn as tcnn
from repro_torch.obs import metrics as tmetrics
from repro_torch.quant import QTensor, quantize_array
from repro_torch.quant.qtensor import scale_tensor

ROOT = Path(__file__).resolve().parents[1]
F32 = torch.float32
I8 = torch.int8
T = torch.from_numpy
J = jnp.asarray
APPS = ["style_transfer", "coloring", "super_resolution"]


def _save_state(cache):
    return (cache.enabled, dict(cache.entries), cache.sweeps, dict(cache.stats),
            cache.ops_filter, cache.path)


def _load_state(cache, state):
    (cache.enabled, cache.entries, cache.sweeps, cache.stats, cache.ops_filter,
     cache.path) = state


@pytest.fixture
def fresh_cache():
    """The port's process-wide cache, emptied, tuning off; restored after."""
    cache = tops.tuning_cache()
    state = _save_state(cache)
    cache.clear()
    cache.enabled = False
    cache.ops_filter = None
    yield cache
    _load_state(cache, state)


@pytest.fixture(autouse=True)
def _port_registry():
    snap = tmetrics.registry().dump_state()
    tops.reset_kernel_launches()
    try:
        yield
    finally:
        tmetrics.registry().load_state(snap)


def _arr(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# --------------------------------------------------------------------------- #
# round-trip                                                                   #
# --------------------------------------------------------------------------- #


def test_roundtrip_preserves_blocks_ms_and_marks_loaded(tmp_path):
    c = TuningCache(enabled=False)
    k1 = TuningCache.key("matmul", 64, 128, 256, F32, "dense", "sm90")
    k2 = TuningCache.key("qmatmul", 64, 128, 256, I8, "dense+w8a8", "sm90")
    c.entries[k1] = TuneEntry((128, 64, 16, 1), "swept", 0.42)
    c.entries[k2] = TuneEntry((64, 64, 16, 2), "swept", 0.17)
    p = str(tmp_path / "tune.json")
    c.save(p)
    c2 = TuningCache(enabled=False).load(p)
    assert c2.entries[k1].blocks == (128, 64, 16, 1)
    assert c2.entries[k1].ms == pytest.approx(0.42)
    assert c2.entries[k2].blocks == (64, 64, 16, 2)
    assert all(e.source == "loaded" for e in c2.entries.values())
    assert json.loads(open(p).read())["version"] == 1


def test_roundtrip_drops_default_placeholders(tmp_path):
    """Seeded defaults were never measured: persisting them would block
    future sweeps of those shapes in other processes."""
    c = TuningCache(enabled=False)
    c.resolve("matmul", 8, 8, 8, F32, "dense", "cpu")  # records a default
    c.entries[TuningCache.key("matmul", 16, 16, 16, F32, "dense", "cpu")] = (
        TuneEntry((64, 64, 32, 1), "swept", 1.0)
    )
    p = str(tmp_path / "tune.json")
    c.save(p)
    entries = json.loads(open(p).read())["entries"]
    assert len(entries) == 1
    assert next(iter(entries.values()))["source"] == "swept"


def test_save_without_path_raises():
    c = TuningCache(enabled=False, path=None)
    with pytest.raises(ValueError, match="no cache path"):
        c.save()


# --------------------------------------------------------------------------- #
# corrupt / partial cache files fall back to the defaults                      #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize(
    "payload",
    [
        "{ not json at all",
        json.dumps({"version": 1}),
        json.dumps({"version": 1, "entries": {"k": {}}}),
        json.dumps({"version": 1, "entries": {"k": None}}),
    ],
)
def test_corrupt_cache_file_warns_and_uses_defaults(tmp_path, payload):
    p = tmp_path / "tune.json"
    p.write_text(payload)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        c = TuningCache(enabled=False, path=str(p))
    assert any("ignoring unreadable tuning cache" in str(x.message) for x in w)
    assert c.resolve("matmul", 8, 8, 8, F32, "dense", "cpu") == (64, 64, 16, 1)
    assert c.resolve("qmatmul", 8, 8, 8, I8, "dense+w8a8", "cpu") == (64, 64, 16, 1)


def test_missing_cache_file_is_silently_fresh(tmp_path):
    c = TuningCache(enabled=False, path=str(tmp_path / "nope.json"))
    assert c.entries == {}


def test_environment_turns_tuning_on_and_loads_the_file_at_import(tmp_path):
    """``REPRO_TUNE`` / ``REPRO_TUNE_CACHE`` are read when the module-level
    cache is made, at import, as in the JAX package."""
    p = tmp_path / "tune.json"
    key = TuningCache.key("matmul", 64, 128, 256, F32, "dense", "cpu")
    c = TuningCache(enabled=False)
    c.entries[key] = TuneEntry((128, 64, 16, 1), "swept", 0.5)
    c.save(str(p))
    code = ("from repro_torch.kernels import ops; c = ops.tuning_cache(); "
            f"print(c.enabled, c.entries[{key!r}].blocks, c.entries[{key!r}].source)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), REPRO_TUNE="1",
               REPRO_TUNE_CACHE=str(p))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["True", "(128,", "64,", "16,", "1)", "loaded"]
    env.pop("REPRO_TUNE")
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.stdout.split()[0] == "False"


# --------------------------------------------------------------------------- #
# key collisions                                                               #
# --------------------------------------------------------------------------- #


def test_cpu_and_card_modes_never_share_a_winner(fresh_cache):
    """A CPU sweep times the plain versions, not the card: a ``cpu`` winner
    never shadows (or is returned for) an ``sm90`` lookup, nor one card's
    another's."""
    shape = ("matmul", 64, 128, 256, F32, "dense")
    k_cpu = TuningCache.key(*shape, "cpu")
    k_card = TuningCache.key(*shape, "sm90")
    assert len({k_cpu, k_card, TuningCache.key(*shape, "sm100")}) == 3
    fresh_cache.entries[k_cpu] = TuneEntry((128, 64, 16, 1), "swept", 9.9)
    assert fresh_cache.lookup(*shape, "sm90") is None
    assert fresh_cache.resolve(*shape, "sm90") == TuningCache.DEFAULTS["matmul"]
    assert fresh_cache.entries[k_cpu].blocks == (128, 64, 16, 1)
    assert tops.device_mode(torch.device("cpu")) == "cpu"


def test_format_and_scheme_axes_key_separately():
    keys = {
        TuningCache.key("matmul", 8, 8, 8, F32, "dense", "cpu"),
        TuningCache.key("matmul", 8, 8, 8, F32, "dense+e2s1", "cpu"),
        TuningCache.key("matmul", 8, 8, 8, F32, "colcompact", "cpu"),
        TuningCache.key("matmul", 8, 8, 8, torch.bfloat16, "dense", "cpu"),
        TuningCache.key("qmatmul", 8, 8, 8, F32, "dense+w8", "cpu"),
        TuningCache.key("qmatmul", 8, 8, 8, I8, "dense+w8a8", "cpu"),
        TuningCache.key("bsr_matmul", 8, 8, 8, F32, "pbcsr", "cpu"),
        TuningCache.key("bsr_matmul", 8, 8, 8, F32, "pbcsr+e1s1", "cpu"),
    }
    assert len(keys) == 8  # no two collapse


def test_loaded_entries_survive_resolve_and_block_sweeps(fresh_cache):
    shape = ("matmul", 64, 128, 256, F32, "dense")
    key = TuningCache.key(*shape, "cpu")
    fresh_cache.entries[key] = TuneEntry((128, 64, 16, 1), "loaded", 0.5)
    fresh_cache.enabled = True
    called = []
    assert fresh_cache.resolve(*shape, "cpu", runner=lambda *b: called.append(b)) == (
        128, 64, 16, 1)
    assert not called and fresh_cache.sweeps == 0


# --------------------------------------------------------------------------- #
# the block tuples: defaults, candidates, legacy entries                       #
# --------------------------------------------------------------------------- #


def test_defaults_carry_pipeline_depth_and_candidates_are_the_built_tiles():
    """The matmul / qmatmul tuple's fourth field is the pipeline depth (1 =
    the tiled kernel), conv2d's tuple the conv kernel's (BM, BN, BK); the
    candidates are exactly the tiles the kernels are built for, at most 8
    a family, depth-2 and depth-3 included."""
    assert TuningCache.DEFAULTS["matmul"] == TuningCache.DEFAULTS["qmatmul"] == (64, 64, 16, 1)
    assert TuningCache.DEFAULTS["conv2d"] == (64, 64, 16)
    for op in ("matmul", "qmatmul"):
        cands = TuningCache.CANDIDATES[op]
        assert cands == _build.GEMM_TILES and len(cands) <= 8
        assert {c[3] for c in cands} == {1, 2, 3}
        assert TuningCache.DEFAULTS[op] in cands
        for n in (8, 32, 33, 4096):  # every default tile at every depth
            d = _build.gemm_default_tile(n)
            assert all((*d[:3], depth) in cands for depth in (1, 2, 3))
    assert TuningCache.CANDIDATES["conv2d"] == _build.CONV_TILES
    assert len(_build.CONV_TILES) <= 8
    for scheme in ("f32", "w8", "w8a8"):
        for o in (2, 4, 12, 16, 32, 64, 128):
            assert _build.conv_default_tile(scheme, o) in _build.CONV_TILES


def test_default_tiles_are_the_shape_based_choice():
    """With no cache entry the kernels run the tiles chosen from the shape:
    the GEMMs' as before the cache; the conv's by output-channel count, up
    to 32 channels on the f32 / W8 body's fastest tile there (256 x 32) and
    W8A8's own body on the one it had (128 x 32)."""
    assert _build.gemm_default_tile(32) == (128, 32, 16, 1)
    assert _build.gemm_default_tile(33) == (64, 64, 16, 1)
    want = {2: (256, 4, 16), 4: (256, 4, 16), 12: (256, 16, 16), 16: (256, 16, 16),
            32: (256, 32, 16), 64: (64, 64, 16)}
    assert {o: _build.conv_default_tile("f32", o) for o in want} == want
    assert _build.conv_default_tile("w8", 4) == (256, 32, 16)
    assert _build.conv_default_tile("w8a8", 4) == (128, 32, 16)
    for scheme in ("w8", "w8a8"):
        assert _build.conv_default_tile(scheme, 64) == (64, 64, 16)


def test_legacy_block_tuples_normalize_without_colliding():
    assert tops._blocks4((128, 64, 16)) == (128, 64, 16, 1)
    assert tops._blocks4((64, 64, 16, 2)) == (64, 64, 16, 2)
    assert tops._conv_blocks3((128, 32)) == (128, 32, 16)
    assert tops._conv_blocks3((128, 64, 16)) == (128, 64, 16)


def test_extended_block_tuples_json_round_trip(tmp_path):
    c = TuningCache(enabled=False)
    km = TuningCache.key("matmul", 64, 128, 512, F32, "dense", "sm90")
    kc = TuningCache.key_nd("conv2d", (1, 256, 16, 16, 64, 3, 3, 1), F32, "dense+f32", "sm90")
    c.entries[km] = TuneEntry((64, 64, 16, 3), "swept", 0.3)
    c.entries[kc] = TuneEntry((128, 64, 16), "swept", 0.7)
    p = str(tmp_path / "tune.json")
    c.save(p)
    c2 = TuningCache(enabled=False).load(p)
    assert c2.entries[km].blocks == (64, 64, 16, 3)
    assert c2.entries[kc].blocks == (128, 64, 16)
    assert all(e.source == "loaded" for e in c2.entries.values())


def test_loaded_pipelined_winner_blocks_sweeps(fresh_cache):
    shape = ("matmul", 64, 128, 512, F32, "dense")
    key = TuningCache.key(*shape, "cpu")
    fresh_cache.entries[key] = TuneEntry((64, 64, 16, 2), "loaded", 0.4)
    fresh_cache.enabled = True
    called = []
    got = fresh_cache.resolve(*shape, "cpu", runner=lambda *b: called.append(b))
    assert got == (64, 64, 16, 2)
    assert not called and fresh_cache.sweeps == 0
    assert fresh_cache.stats["matmul"] == {"hits": 1, "misses": 0, "sweeps": 0}


def test_ops_filter_restricts_sweeps_but_not_lookups(fresh_cache):
    fresh_cache.enabled = True
    fresh_cache.ops_filter = frozenset({"conv2d"})
    swept = []

    def runner(*blocks):
        swept.append(blocks)
        return torch.zeros(())

    shape = ("matmul", 64, 128, 128, F32, "dense")
    got = fresh_cache.resolve(*shape, "cpu", runner=runner)
    assert got == TuningCache.DEFAULTS["matmul"] and not swept
    assert fresh_cache.stats["matmul"]["sweeps"] == 0
    fresh_cache.resolve_nd("conv2d", (1, 8, 8, 8, 4, 3, 3, 1), F32, "dense+f32", "cpu",
                           runner=runner)
    assert swept and fresh_cache.stats["conv2d"]["sweeps"] == 1
    key = TuningCache.key(*shape, "cpu")
    fresh_cache.entries[key] = TuneEntry((64, 64, 32, 1), "swept", 0.2)
    assert fresh_cache.resolve(*shape, "cpu") == (64, 64, 32, 1)


def test_stats_report_csv_counts_per_family(fresh_cache):
    fresh_cache.resolve("matmul", 8, 8, 8, F32, "dense", "cpu")  # miss
    fresh_cache.resolve("matmul", 8, 8, 8, F32, "dense", "cpu")  # hit
    fresh_cache.resolve("qmatmul", 8, 8, 8, I8, "dense+w8a8", "cpu")
    lines = fresh_cache.stats_report().splitlines()
    assert lines[0] == "family,hits,misses,sweeps"
    assert "matmul,1,1,0" in lines and "qmatmul,0,1,0" in lines
    report = fresh_cache.report().splitlines()
    assert report[0] == "op,shape,dtype,format,mode,blocks,source,ms"
    assert "matmul,8x8x8,float32,dense,cpu,64x64x16x1,default," in report
    fresh_cache.clear()
    assert fresh_cache.stats_report() == "family,hits,misses,sweeps"


# --------------------------------------------------------------------------- #
# crash-safe (atomic) save                                                     #
# --------------------------------------------------------------------------- #


def _cache_with_entry(key_dims=(64, 128, 256), blocks=(128, 64, 16, 1)):
    c = TuningCache(enabled=False)
    k = TuningCache.key("matmul", *key_dims, F32, "dense", "sm90")
    c.entries[k] = TuneEntry(blocks, "swept", 0.5)
    return c, k


def test_interrupted_save_leaves_previous_file_intact(tmp_path, monkeypatch):
    c, _ = _cache_with_entry()
    p = str(tmp_path / "tune.json")
    c.save(p)
    before = open(p).read()

    def boom(obj, f, **kw):
        f.write('{"version": 1, "entr')
        raise RuntimeError("disk full")

    monkeypatch.setattr(json, "dump", boom)
    with pytest.raises(RuntimeError, match="disk full"):
        c.save(p)
    assert open(p).read() == before
    assert json.loads(open(p).read())["entries"]
    assert [f for f in tmp_path.iterdir() if f.name != "tune.json"] == []


def test_concurrent_saves_never_expose_truncated_json(tmp_path):
    c1, _ = _cache_with_entry((64, 128, 256), (128, 64, 16, 1))
    c2, _ = _cache_with_entry((32, 64, 512), (64, 64, 16, 2))
    for i in range(50):
        k = TuningCache.key_nd("conv2d", (1, 8 + i, 8, 8, 4, 3, 3, 1), F32, "dense+f32", "cpu")
        c2.entries[k] = TuneEntry((128, 32, 16), "swept", float(i))
    p = str(tmp_path / "tune.json")
    c1.save(p)
    stop = threading.Event()
    errors = []

    def writer(c):
        while not stop.is_set():
            try:
                c.save(p)
            except Exception as e:  # pragma: no cover - fails the test below
                errors.append(e)
                return

    threads = [threading.Thread(target=writer, args=(c,)) for c in (c1, c2)]
    for t in threads:
        t.start()
    try:
        for _ in range(200):
            payload = json.loads(open(p).read())
            assert payload["version"] == 1
            assert len(payload["entries"]) in (1, 51)
    finally:
        stop.set()
        for t in threads:
            t.join()
    assert errors == []


def test_save_still_returns_path_and_roundtrips(tmp_path):
    c, k = _cache_with_entry()
    (tmp_path / "sub").mkdir()
    target = str(tmp_path / "sub" / "tune.json")
    assert c.save(target) == target
    assert TuningCache(enabled=False).load(target).entries[k].blocks == (128, 64, 16, 1)


# --------------------------------------------------------------------------- #
# across the two packages                                                      #
# --------------------------------------------------------------------------- #

#: (op, dims, torch dtype, jnp dtype, fmt)
KEY_CASES = [
    ("matmul", (4096, 192, 32), F32, jnp.float32, "conv1x1.dense+e1s1"),
    ("matmul", (48, 2048, 2048), torch.bfloat16, jnp.bfloat16, "dense"),
    ("qmatmul", (4, 64, 64), I8, jnp.int8, "colcompact+w8a8"),
    ("qmatmul", (37, 50, 70), F32, jnp.float32, "dense+w8+e2s2"),
    ("conv2d", (4, 96, 256, 256, 32, 3, 3, 1), F32, jnp.float32, "channelcompact+f32+e1s1"),
    ("conv2d", (2, 24, 37, 29, 40, 3, 3, 2), I8, jnp.int8, "dense+w8a8+valid"),
    ("fused_elementwise", (512, 256, 2), F32, jnp.float32, "ew+s2n0"),
    ("bsr_matmul", (3, 2048, 2048), torch.bfloat16, jnp.bfloat16, "pbcsr+e1s1"),
]


@pytest.mark.parametrize("case", KEY_CASES, ids=[f"{c[0]}-{c[4]}" for c in KEY_CASES])
def test_keys_equal_jax_keys_except_the_mode(case):
    op, dims, tdt, jdt, fmt = case
    port = TuningCache.key_nd(op, dims, tdt, fmt, "sm90")
    jax_hw = JTuningCache.key_nd(op, dims, jdt, fmt, False)
    jax_int = JTuningCache.key_nd(op, dims, jdt, fmt, True)
    head = port.rsplit("|", 1)[0]
    assert head == jax_hw.rsplit("|", 1)[0] == jax_int.rsplit("|", 1)[0]
    assert port.endswith("|sm90") and jax_hw.endswith("|hw") and jax_int.endswith("|interpret")
    assert TuningCache.key_nd(op, dims, tdt, fmt, "cpu") == head + "|cpu"


def test_jax_file_loads_into_the_port_and_hits_no_port_key(tmp_path, fresh_cache):
    """A TPU- or interpret-tuned file loads without error; its ``|hw`` /
    ``|interpret`` winners never steer the port (none of its keys is a port
    key)."""
    jc = JTuningCache(enabled=False)
    for op, dims, _, jdt, fmt in KEY_CASES:
        for interp in (False, True):
            blocks = (256, 128, 128, 2) if op in ("matmul", "qmatmul") else (128,)
            jc.entries[JTuningCache.key_nd(op, dims, jdt, fmt, interp)] = JTuneEntry(
                blocks, "swept", 1.0)
    p = str(tmp_path / "jax.json")
    jc.save(p)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        loaded = TuningCache(enabled=False, path=p)
    assert len(loaded.entries) == len(jc.entries)
    for op, dims, tdt, _, fmt in KEY_CASES:
        for mode in ("cpu", "sm90"):
            assert loaded.lookup_nd(op, dims, tdt, fmt, mode) is None
    # and through a wrapper: the port's own default, not the JAX winner
    fresh_cache.load(p)
    rng = np.random.default_rng(0)
    x, w = T(_arr(rng, 4096, 32)), T(_arr(rng, 32, 192))
    tops.matmul(x, w)
    assert fresh_cache.lookup("matmul", 4096, 192, 32, F32, "dense", "cpu") == (64, 64, 16, 1)


def test_port_file_loads_into_jax_and_hits_no_jax_key(tmp_path):
    c = TuningCache(enabled=False)
    for op, dims, tdt, _, fmt in KEY_CASES:
        for mode in ("cpu", "sm90"):
            blocks = (64, 64, 16, 2) if op in ("matmul", "qmatmul") else (128, 32, 16)
            c.entries[TuningCache.key_nd(op, dims, tdt, fmt, mode)] = TuneEntry(
                blocks, "swept", 1.0)
    p = str(tmp_path / "port.json")
    c.save(p)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        jc = JTuningCache(enabled=False, path=p)
    assert len(jc.entries) == len(c.entries)
    for op, dims, _, jdt, fmt in KEY_CASES:
        for interp in (False, True):
            assert jc.lookup_nd(op, dims, jdt, fmt, interp) is None


# --------------------------------------------------------------------------- #
# the keys a plan resolves: equal to the JAX package's                         #
# --------------------------------------------------------------------------- #


def _heads(entries):
    return {k.rsplit("|", 1)[0] for k in entries}


@pytest.mark.parametrize("app", APPS)
@pytest.mark.parametrize("backend", ["kernel", "quant"])
def test_plans_resolve_the_jax_packages_keys(app, backend, fresh_cache):
    """The same numpy-seeded graph (base 8, 16x16 frames), tuning off in
    both: the (op, dims, dtype, format) of every key the port's plan
    resolves equals the JAX package's (its plan abstract-evaluated: the
    wrappers resolve their keys while tracing)."""
    c = quant_case(app)
    jg, tg = (c["jgo"], c["tgo"]) if backend == "kernel" else (c["jgq"], c["tgq"])
    shape = (1, tcnn.APP_INPUT_CHANNELS[app], 16, 16)
    jcache = jops.tuning_cache()
    saved = (jcache.enabled, dict(jcache.entries), jcache.sweeps, dict(jcache.stats))
    try:
        jcache.clear()
        jcache.enabled = False
        jplan = jcompile_plan(jg, backend=backend)
        jax.eval_shape(lambda p, x: jplan(p, x), jg.params,
                       jax.ShapeDtypeStruct(shape, jnp.float32))
        want = _heads(jcache.entries)
    finally:
        jcache.enabled, jcache.entries, jcache.sweeps, jcache.stats = saved
    x = T(_arr(np.random.default_rng(3), *shape))
    compile_plan(tg, backend=backend, device="cpu")(tg.params, x)
    got = _heads(fresh_cache.entries)
    assert got == want
    assert all(k.endswith("|cpu") for k in fresh_cache.entries)
    ops = {k.split("|")[0] for k in got}
    assert "conv2d" in ops and ({"matmul"} if backend == "kernel" else {"qmatmul"}) <= ops
    assert all(e.source == "default" for e in fresh_cache.entries.values())


# --------------------------------------------------------------------------- #
# pins, pipeline depths and tiles through the wrappers                         #
# --------------------------------------------------------------------------- #

TILE_PINS = [dict(block_m=t[0], block_n=t[1], block_k=t[2], pipeline=t[3])
             for t in _build.GEMM_TILES] + [dict(pipeline=2), dict(pipeline=3)]
PIN_IDS = ["x".join(map(str, t)) for t in _build.GEMM_TILES] + ["pipeline2", "pipeline3"]


@pytest.mark.parametrize("pins", TILE_PINS, ids=PIN_IDS)
def test_matmul_pinned_tiles_give_the_unpinned_result(pins, fresh_cache):
    rng = np.random.default_rng(21)
    x, w, b = _arr(rng, 2, 37, 70), _arr(rng, 70, 50, scale=0.1), _arr(rng, 50)
    side = _arr(rng, 2, 37, 50)
    kw = dict(activation="relu", epilogue=(("add", 0),))
    want = tops.matmul(T(x), T(w), T(b), epilogue_sides=[T(side)], **kw)
    got = tops.matmul(T(x), T(w), T(b), epilogue_sides=[T(side)], **kw, **pins)
    assert torch.equal(got, want)
    oracle = jref.apply_steps_ref(jref.matmul_ref(J(x), J(w), J(b), activation="relu"),
                                  (("add", 0),), [J(side)])
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), rtol=1e-5, atol=1e-5)
    # a pinned call never records a key; the unpinned one did, with the default
    assert list(fresh_cache.entries) == [
        TuningCache.key("matmul", 74, 50, 70, F32, "dense+e1s1", "cpu")]


def _w8a8_exact(x, wq, w_scale, b, x_scale):
    """The W8A8 function with integer sums taken exactly (int64), then the
    kernels' f32 rescale: ``(sum x_q w_q) * (w_scale * x_scale) + b``."""
    s = scale_tensor(x_scale, x)
    xq = quantize_array(x, s)
    acc = xq.numpy().astype(np.int64) @ wq.numpy().astype(np.int64)
    ws = (w_scale.float() * s).numpy()
    return torch.relu(T(acc.astype(np.float32)) * T(ws) + b)


@pytest.mark.parametrize("pins", TILE_PINS, ids=PIN_IDS)
@pytest.mark.parametrize("scheme", ["w8", "w8a8"])
def test_qmatmul_pinned_tiles_give_the_unpinned_result(pins, scheme, fresh_cache):
    rng = np.random.default_rng(22)
    x, w, b = _arr(rng, 37, 72), _arr(rng, 72, 52, scale=0.1), _arr(rng, 52)
    qt = QTensor.from_float(T(w), axis=1)
    x_scale = float(np.abs(x).max()) / 127.0 if scheme == "w8a8" else None
    kw = dict(x_scale=x_scale, activation="relu")
    want = tops.qmatmul(T(x), qt.values, qt.scale, T(b), **kw)
    got = tops.qmatmul(T(x), qt.values, qt.scale, T(b), **kw, **pins)
    assert torch.equal(got, want)
    if scheme == "w8a8":
        assert torch.equal(got, _w8a8_exact(T(x), qt.values, qt.scale, T(b), x_scale))
    oracle = jref.qmatmul_ref(J(x), J(qt.values.numpy()), J(qt.scale.numpy()), J(b),
                              x_scale=x_scale, activation="relu")
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tile", _build.CONV_TILES, ids=lambda t: "x".join(map(str, t)))
@pytest.mark.parametrize("scheme", ["f32", "w8a8"])
def test_conv2d_pinned_tiles_give_the_unpinned_result(tile, scheme, fresh_cache):
    rng = np.random.default_rng(23)
    x, w, b = _arr(rng, 2, 6, 11, 10), _arr(rng, 5, 4, 3, 3, scale=0.3), _arr(rng, 5)
    kept = T(np.array([0, 2, 3, 5], np.int32))
    kw = dict(stride=2, kept=kept, activation="relu")
    if scheme == "w8a8":
        qt = QTensor.from_float(T(w), axis=0)
        wt = qt.values
        kw.update(w_scale=qt.scale, x_scale=float(np.abs(x).max()) / 127.0)
    else:
        wt = T(w)
    want = tops.conv2d(T(x), wt, T(b), **kw)
    got = tops.conv2d(T(x), wt, T(b), **kw, block_m=tile[0], block_n=tile[1], block_k=tile[2])
    assert torch.equal(got, want)
    key = fresh_cache.entries.popitem()[0]
    fmt = "channelcompact+" + scheme
    assert key == TuningCache.key_nd("conv2d", (2, 4, 11, 10, 5, 3, 3, 2),
                                     I8 if scheme == "w8a8" else F32, fmt, "cpu")
    assert not fresh_cache.entries  # the pinned call recorded nothing


def test_tiles_not_built_raise_naming_the_key(fresh_cache):
    rng = np.random.default_rng(24)
    x, w = T(_arr(rng, 9, 20)), T(_arr(rng, 20, 12))
    with pytest.raises(_build.TileError, match=r"matmul\|9x12x20\|float32\|dense\|cpu.*"
                                               r"\(128, 128, 16, 1\)"):
        tops.matmul(x, w, block_m=128, block_n=128)
    with pytest.raises(_build.TileError, match=r"\(128, 32, 16, 4\)"):
        tops.matmul(x, w, pipeline=4)  # N = 12: the default tile is 128 x 32 x 16
    with pytest.raises(_build.TileError, match=r"\(128, 64, 16, 2\)"):
        tops.matmul(x, w, block_n=64, pipeline=2)  # partially pinned: rest from the default
    qt = QTensor.from_float(w, axis=1)
    with pytest.raises(_build.TileError, match=r"qmatmul\|9x12x20\|int8\|dense\+w8a8\|cpu"):
        tops.qmatmul(x, qt.values, qt.scale, x_scale=0.05, block_k=64)
    xc = T(_arr(rng, 1, 3, 8, 8))
    with pytest.raises(_build.TileError, match=r"conv2d\|1x3x8x8x4x3x3x1\|float32\|dense\+f32"):
        tops.conv2d(xc, T(_arr(rng, 4, 3, 3, 3)), block_m=32)
    with pytest.raises(_build.TileError, match="no pipelined variant"):
        tops.conv2d(xc, T(_arr(rng, 4, 3, 3, 3)), pipeline=2)
    # the kernel wrappers check too (CPU route included)
    from repro_torch.kernels import dense_matmul_pipelined as tdp
    with pytest.raises(_build.TileError, match="depth 1 is the tiled kernel"):
        tdp.dense_matmul_pipelined(x, w, depth=1)


def test_loaded_entry_naming_no_built_tile_raises_with_its_key(fresh_cache):
    """A loaded winner is never replaced quietly: a tile the kernels lack
    raises, naming the key."""
    rng = np.random.default_rng(25)
    x, w = T(_arr(rng, 9, 20)), T(_arr(rng, 20, 12))
    key = TuningCache.key("matmul", 9, 12, 20, F32, "dense", "cpu")
    fresh_cache.entries[key] = TuneEntry((256, 128, 128, 2), "loaded", 0.1)
    with pytest.raises(_build.TileError, match=re.escape(key)):
        tops.matmul(x, w)
    xc = T(_arr(rng, 1, 3, 8, 8))
    ckey = TuningCache.key_nd("conv2d", (1, 3, 8, 8, 4, 3, 3, 1), F32, "dense+f32", "cpu")
    fresh_cache.entries[ckey] = TuneEntry((8, 128, 0), "loaded", 0.1)  # a JAX-style tuple
    with pytest.raises(_build.TileError, match=re.escape(ckey)):
        tops.conv2d(xc, T(_arr(rng, 4, 3, 3, 3)))
    ekey = TuningCache.key("fused_elementwise", 8, 16, 1, F32, "ew+s1n0", "cpu")
    fresh_cache.entries[ekey] = TuneEntry((128,), "loaded", 0.1)
    with pytest.raises(_build.TileError, match=re.escape(ekey)):
        tops.fused_elementwise(T(_arr(rng, 8, 16)), [T(_arr(rng, 8, 16))], (("add", 0),))


def test_sweep_on_the_cpu_times_the_plain_version_and_skips_ruled_out_tiles(fresh_cache):
    """With tuning on, the first call of a key sweeps the candidates (the
    plain version on the CPU, timed on the host) and stores the winner with
    its ms; a ``pipeline`` pin rules out the tiles not built at that depth,
    which the sweep skips."""
    rng = np.random.default_rng(26)
    x, w = T(_arr(rng, 40, 24)), T(_arr(rng, 24, 16))
    fresh_cache.enabled = True
    tried = []
    real = tops._dense_call

    def spy(x2, w_, bias, sides2, act, epi, tile):
        out = real(x2, w_, bias, sides2, act, epi, tile)  # raises TileError for a tile not built
        tried.append(tile)
        return out

    try:
        tops._dense_call = spy
        want = x @ w
        got = tops.matmul(x, w, pipeline=2)
    finally:
        tops._dense_call = real
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    e = fresh_cache.entries[TuningCache.key("matmul", 40, 16, 24, F32, "dense", "cpu")]
    assert e.source == "swept" and e.ms > 0 and e.blocks in _build.GEMM_TILES
    swept = {t for t in tried[:-1]}
    assert swept == {t for t in _build.GEMM_TILES if t[3] == 2}  # 128x64 / 64x64x32 skipped
    assert all(t[3] == 2 for t in tried)
    assert fresh_cache.sweeps == 1 and fresh_cache.stats["matmul"]["sweeps"] == 1


def test_one_configuration_kernels_record_their_keys_and_never_sweep(fresh_cache):
    rng = np.random.default_rng(27)
    fresh_cache.enabled = True
    x = T(_arr(rng, 2, 5, 16))
    tops.fused_elementwise(x, [x], (("add", 0), ("activation", "relu")))
    from repro_torch.core.sparse import PBCSR
    from repro_torch.core.pruning import Block, project

    wd = T(_arr(rng, 32, 32))
    mask = project(wd, Block(0.5, bm=8, bn=8))[1]
    f = PBCSR.from_dense(wd, mask, 8, 8)
    tops.bsr_matmul(T(_arr(rng, 3, 32)), f.values, f.block_rows)
    keys = {k: e for k, e in fresh_cache.entries.items()}
    assert keys == {
        TuningCache.key("fused_elementwise", 10, 16, 2, F32, "ew+s1n0", "cpu"):
            TuneEntry((4,), "default"),
        TuningCache.key("bsr_matmul", 3, 32, 32, F32, "pbcsr", "cpu"): TuneEntry((8,), "default"),
    }
    assert fresh_cache.sweeps == 0


def test_bf16_skinny_route_stays_outside_the_cache(fresh_cache):
    """bf16 calls with at most 8 rows take the skinny split-K kernel, whose
    split is planned from (M, N, K): no key; 9 rows resolve one."""
    rng = np.random.default_rng(28)
    w = T(_arr(rng, 64, 32)).to(torch.bfloat16)
    tops.matmul(T(_arr(rng, 8, 64)).to(torch.bfloat16), w)
    assert fresh_cache.entries == {}
    tops.matmul(T(_arr(rng, 9, 64)).to(torch.bfloat16), w)
    assert list(fresh_cache.entries) == [
        TuningCache.key("matmul", 9, 32, 64, torch.bfloat16, "dense", "cpu")]


def test_tile_tables_match_the_cuda_sources():
    """``_build``'s tile lists are the ones ``csrc/tiles.cuh`` instantiates."""
    src = (ROOT / "src/repro_torch/kernels/csrc/tiles.cuh").read_text()

    def tiles(macro):
        body = src.split(f"#define {macro}(X)")[1].split("\n\n")[0]
        return [tuple(int(v) for v in t.split(",")) for t in re.findall(r"X\(([^)]*)\)", body)]

    tiled = [(*t, 1) for t in tiles("REPRO_GEMM_TILED_TILES")]
    assert tuple(tiled + tiles("REPRO_GEMM_PIPELINED_TILES")) == _build.GEMM_TILES
    assert tuple(t[:3] for t in tiles("REPRO_CONV_TILES")) == _build.CONV_TILES


@pytest.mark.parametrize("padding,token", [("SAME", ""), ("VALID", "+valid"),
                                           (((1, 0), (0, 1)), "+p1.0.0.1"),
                                           ([[1, 0], [0, 1]], "+p1.0.0.1")],
                         ids=["same", "valid", "pairs", "lists"])
def test_conv_keys_carry_the_padding_token(padding, token, fresh_cache):
    """SAME keys bare, VALID and explicit pads suffixed (as in the JAX
    package); explicit pads given as lists key like tuples."""
    rng = np.random.default_rng(29)
    x, w = T(_arr(rng, 1, 3, 8, 8)), T(_arr(rng, 4, 3, 3, 3))
    tops.conv2d(x, w, padding=padding, epilogue=(("activation", "relu"),))
    (key,) = fresh_cache.entries
    assert key == TuningCache.key_nd("conv2d", (1, 3, 8, 8, 4, 3, 3, 1), F32,
                                     f"dense+f32{token}+e1s0", "cpu")
    assert key.rsplit("|", 1)[0] == JTuningCache.key_nd(
        "conv2d", (1, 3, 8, 8, 4, 3, 3, 1), jnp.float32,
        "dense+f32" + jops.conv_padding_token(
            padding if isinstance(padding, str) else tuple(map(tuple, padding))) + "+e1s0",
        False).rsplit("|", 1)[0]
