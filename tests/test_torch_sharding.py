"""The port's sharding rules, ZeRO-1 specs and dry-run input specs against
the JAX package's, in one process (no mesh, no ranks).

* ``param_pspecs`` under ``DEFAULT_RULES`` and ``FSDP_RULES``: for every
  arch's smoke params (the JAX tree from ``jax.eval_shape`` of its init,
  the port's from ``flops.meta_params``), the same spec at every leaf path;
* ``zero1_pspecs``: the same moment specs, with and without the params
  (data sizes 2 and 16);
* ``param_placements``: a spec's DTensor placements on a mesh (a dim over
  ``("pod", "data")`` is ``Shard`` on both);
* ``input_specs``: for every (arch, shape) cell the JAX package runs
  (``configs.shape_cells``), the same step name and, leaf for leaf, the same
  shapes and dtypes, the port's as ``device="meta"`` tensors (full-size
  configs: no memory on either side).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import smoke_config as jsmoke_config
from repro.models import get_model as jget_model
from repro.models import sharding as jsharding
from repro.training import optimizer as joptimizer
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shape_cells, smoke_config
from repro_torch.models import get_model
from repro_torch.models import sharding
from repro_torch.training import optimizer
from repro_torch.utils.flops import meta_params
from repro_torch.utils.tree import leaves_with_path

_JSHAPES = {}


def _jax_shapes(arch):
    if arch not in _JSHAPES:
        model = jget_model(jsmoke_config(arch))
        _JSHAPES[arch] = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    return _JSHAPES[arch]


def _jax_specs(tree):
    """``{keystr path: tuple(spec)}`` of a JAX spec tree."""
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {jax.tree_util.keystr(p): tuple(s) for p, s in flat}


def _port_specs(tree):
    return {p: tuple(s) for p, s in leaves_with_path(tree)}


@pytest.mark.parametrize("rules", ["default", "fsdp"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_pspecs_equal_jax(arch, rules):
    jrules = None if rules == "default" else jsharding.FSDP_RULES
    trules = None if rules == "default" else sharding.FSDP_RULES
    want = _jax_specs(jsharding.param_pspecs(_jax_shapes(arch), jrules))
    got = _port_specs(sharding.param_pspecs(meta_params(smoke_config(arch)), trules))
    assert got == want
    assert any(s for s in got.values()), "no leaf sharded"


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_zero1_pspecs_equal_jax(arch):
    jp = jsharding.param_pspecs(_jax_shapes(arch))
    tparams = meta_params(smoke_config(arch))
    tp = sharding.param_pspecs(tparams)
    assert _port_specs(optimizer.zero1_pspecs(tp)) == _jax_specs(joptimizer.zero1_pspecs(jp))
    for data_size in (2, 16):
        want = joptimizer.zero1_pspecs(jp, _jax_shapes(arch), data_size=data_size)
        got = optimizer.zero1_pspecs(tp, tparams, data_size=data_size)
        assert _port_specs(got) == _jax_specs(want), data_size
    fsdp = sharding.param_pspecs(tparams, sharding.FSDP_RULES)
    assert _port_specs(optimizer.zero1_pspecs(fsdp, tparams, data_size=2)) == _jax_specs(
        joptimizer.zero1_pspecs(jsharding.param_pspecs(_jax_shapes(arch), jsharding.FSDP_RULES),
                                _jax_shapes(arch), data_size=2))


class _Mesh:
    """What ``param_placements`` reads of a ``DeviceMesh``."""

    def __init__(self, *names):
        self.mesh_dim_names = names


def test_param_placements_and_batch_spec():
    from torch.distributed.tensor import Replicate, Shard

    P = sharding.P
    mesh = _Mesh("pod", "data", "model")
    assert sharding.param_placements(mesh, P(("pod", "data"), "model")) == [
        Shard(0), Shard(0), Shard(1)]
    assert sharding.param_placements(mesh, P(None, "model")) == [Replicate(), Replicate(),
                                                                 Shard(1)]
    assert sharding.param_placements(mesh, P()) == [Replicate()] * 3
    with pytest.raises(ValueError, match="pipe"):
        sharding.param_placements(mesh, P("pipe"))
    assert sharding.batch_spec(mesh) == P(("pod", "data"))
    assert sharding.batch_spec(_Mesh("data", "model")) == P("data")
    assert P("a", None) == P("a", None) and P("a") != P("a", None)
    assert tuple(P(["pod", "data"])) == (("pod", "data"),)


def _cells():
    return [(a, s) for a in ARCH_IDS for s, st in shape_cells(a).items() if st == "run"]


def _jax_leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(p): (tuple(x.shape), np.dtype(x.dtype).name) for p, x in flat}


def _port_leaves(tree):
    out = {}
    for p, t in leaves_with_path(tree):
        assert t.device.type == "meta", p
        out[p] = (tuple(t.shape), str(t.dtype).replace("torch.", ""))
    return out


@pytest.mark.parametrize("arch,shape", _cells())
def test_input_specs_equal_jax(arch, shape):
    jstep, jbatch, jcaches = jget_model(jget_config(arch)).input_specs(JSHAPES[shape])
    step, batch, caches = get_model(get_config(arch)).input_specs(SHAPES[shape])
    assert step == jstep
    assert _port_leaves(batch) == _jax_leaves(jbatch)
    if jcaches is None:
        assert caches is None
    else:
        assert _port_leaves(caches) == _jax_leaves(jcaches)


def test_input_specs_allocate_nothing():
    """The dry run's full-size decode caches stay on the meta device."""
    _, _, caches = get_model(get_config("qwen3-14b")).input_specs(SHAPES["decode_32k"])
    assert all(t.device.type == "meta" for _, t in leaves_with_path(caches))
    assert sum(t.numel() * t.element_size() for _, t in leaves_with_path(caches)) > 1e10
    assert torch.empty(0).device.type == "cpu"
