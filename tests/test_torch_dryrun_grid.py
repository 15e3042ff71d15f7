"""The port's dry run over every zoo family's smoke cells, on the CPU, in one
process (a ``"fake"`` process group and meta tensors, as
``tests/test_torch_dryrun.py``): every family x {train, prefill, decode} x
{``DEFAULT_RULES``, ``FSDP_RULES``} on (2, 2) and (4, 1) ``(data, model)``
meshes runs (``ok``), counts FLOPs and holds at least its arguments live.

A decode cell's caches are placed as the JAX package's ``_cache_pspecs``
places them (batch over ``data``, sequence, heads or channels over
``model``).  Its attention runs on each rank's slots of the cache and
combines the slots' partial softmaxes over ``model``
(``sharding.on_cache``); the Mamba-2 / RG-LRU mixers run on each rank's
heads or channels, their state and conv window where they lie
(``sharding.on_mixer``).  So every collective a decode step issues moves
activations or weights, never a cache: its bytes by kind are the same at
two cache lengths.
"""

import functools

import pytest

from repro_torch.configs import ARCH_IDS, smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun

MESHES = {"2x2": ((2, 2), ("data", "model")), "4x1": ((4, 1), ("data", "model"))}
SHAPES = {"train_4k": ShapeConfig("train_4k", 32, 8, "train"),
          "prefill_32k": ShapeConfig("prefill_32k", 64, 4, "prefill"),
          "decode_32k": ShapeConfig("decode_32k", 64, 4, "decode")}
STEPS = {"train_4k": "train_step", "prefill_32k": "prefill", "decode_32k": "serve_step"}
RULES = ("default", "fsdp")


@functools.lru_cache(maxsize=None)
def _cell(arch, shape, mesh, rules, seq=None):
    sc = SHAPES[shape]
    if seq is not None:
        sc = ShapeConfig(sc.name, seq, sc.global_batch, sc.kind)
    return dryrun.run_cell(arch, shape, "single", cfg_override=smoke_config(arch),
                           mesh_shape=MESHES[mesh], shape_override=sc, verbose=False,
                           overrides={"rules": rules})


@pytest.mark.parametrize("rules", RULES)
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_cell_runs(arch, shape, mesh, rules):
    rec = _cell(arch, shape, mesh, rules)
    assert rec["ok"], rec.get("error")
    assert rec["step"] == STEPS[shape] and rec["rules"] == rules and rec["chips"] == 4
    assert rec["cost"]["flops"] > 0
    m = rec["memory"]
    assert m["live_bytes"] >= m["argument_bytes"] > 0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_collectives_do_not_grow_with_the_cache(arch):
    """One sharded decode step at 64 and at 128 cache slots (``DEFAULT_RULES``,
    (2, 2)): the same collective bytes by kind -- no rank gathers a KV or
    latent cache -- while the cache arguments grow."""
    short, long = (_cell(arch, "decode_32k", "2x2", "default", seq=n) for n in (64, 128))
    assert short["ok"] and long["ok"], (short.get("error"), long.get("error"))
    assert short["collectives"]["per_kind"] == long["collectives"]["per_kind"]
    if not smoke_config(arch).ssm:  # a Mamba-2 state has no sequence axis
        assert long["memory"]["argument_bytes"] > short["memory"]["argument_bytes"]
