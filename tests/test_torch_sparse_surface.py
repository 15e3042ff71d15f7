"""The rest of the JAX package's public surface in the port, on the CPU: the
packing helpers and the CSR storage baseline of ``core.sparse``, held bit
for bit to the JAX package's on the same numpy arrays, and every
subpackage's exported names held to the JAX package's.

Two names of the JAX package have no counterpart, and are the only
exceptions: ``kernels.interpret_default`` (a Pallas interpret-mode switch:
in the port the tensors' device picks the route) and ``utils.
collective_bytes`` / ``utils.op_histogram`` (parsers of XLA HLO text:
``utils/op_costs.py`` counts the eager ops and collectives instead).
"""

import ast
import importlib
import os
import subprocess
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pruning import Block as JBlock
from repro.core.pruning import project as jproject
from repro.core.sparse import formats as jformats
from repro.core.sparse import packing as jpacking
from repro_torch.core.pruning import Block, project
from repro_torch.core.sparse import (
    CSR,
    PBCSR,
    block_mask,
    dense_nbytes,
    extract_blocks,
    pack_balanced,
    pad_to_multiple,
    unpack_balanced,
)

ROOT = Path(__file__).resolve().parents[1]

#: names the JAX package exports that the port does not (see the module doc)
EXCEPTIONS = {
    "kernels": {"interpret_default"},
    "utils": {"collective_bytes", "op_histogram"},
}


def _arr(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _eq(got, want):
    """Bit-equal values, same shape and dtype (torch vs numpy / jax)."""
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, g.dtype, w.shape, w.dtype)
    np.testing.assert_array_equal(g, w)


# --------------------------------------------------------------------------- #
# packing helpers                                                              #
# --------------------------------------------------------------------------- #

PAD_CASES = [  # (shape, multiple, axis)
    ((10, 7), 4, 0),  # ragged rows
    ((10, 7), 4, 1),  # ragged columns
    ((10, 7), 5, 0),  # already a multiple: no pad
    ((3, 5, 6), 4, -1),  # a negative axis
    ((3, 5, 6), 8, 1),  # a middle axis
]


@pytest.mark.parametrize("case", PAD_CASES, ids=lambda c: f"{c[0]}-m{c[1]}-a{c[2]}")
def test_pad_to_multiple_bit_equal_to_jax(case):
    shape, mult, axis = case
    x = _arr(np.random.default_rng(0), *shape)
    got = pad_to_multiple(torch.from_numpy(x), mult, axis)
    _eq(got, jpacking.pad_to_multiple(jnp.asarray(x), mult, axis))
    assert got.shape[axis] % mult == 0


@pytest.mark.parametrize("shape,bm,bn", [((8, 12), 4, 3), ((64, 32), 16, 16), ((6, 6), 6, 1)])
def test_extract_blocks_bit_equal_to_jax(shape, bm, bn):
    w = _arr(np.random.default_rng(1), *shape)
    _eq(extract_blocks(torch.from_numpy(w), bm, bn),
        jpacking.extract_blocks(jnp.asarray(w), bm, bn))


def _bmask_cases():
    rng = np.random.default_rng(2)
    ragged = rng.random((6, 5)) < 0.4
    empty_column = ragged.copy()
    empty_column[:, 2] = False  # a column that keeps no block
    return {
        "ragged": ragged,
        "empty-column": empty_column,
        "all-kept": np.ones((3, 4), bool),
        "none-kept": np.zeros((4, 3), bool),  # s_max stays 1
        "one-block": np.eye(1, 5, 3, dtype=bool).reshape(1, 5),
    }


BMASKS = _bmask_cases()


@pytest.mark.parametrize("name", sorted(BMASKS))
def test_pack_and_unpack_balanced_bit_equal_to_jax(name):
    bmask = BMASKS[name]
    bm, bn = 4, 2
    kb, nb = bmask.shape
    w = _arr(np.random.default_rng(3), kb * bm, nb * bn)
    values, rows = pack_balanced(torch.from_numpy(w), bmask, bm, bn)
    jvalues, jrows = jpacking.pack_balanced(jnp.asarray(w), bmask, bm, bn)
    _eq(values, jvalues)
    _eq(rows, jrows)
    assert rows.dtype == torch.int32 and values.shape[1] >= 1
    back = unpack_balanced(values, rows, (kb * bm, nb * bn), bm, bn)
    _eq(back, jpacking.unpack_balanced(jvalues, jrows, (kb * bm, nb * bn), bm, bn))
    # the round trip keeps exactly the kept blocks
    keep = np.kron(bmask, np.ones((bm, bn), bool))
    np.testing.assert_array_equal(back.numpy(), np.where(keep, w, 0.0))


def test_pack_balanced_keeps_the_weight_dtype_and_takes_a_tensor_mask():
    rng = np.random.default_rng(4)
    w = torch.from_numpy(_arr(rng, 16, 8)).to(torch.bfloat16)
    bmask = torch.from_numpy(rng.random((4, 4)) < 0.5)
    values, rows = pack_balanced(w, bmask, 4, 2)
    assert values.dtype == torch.bfloat16 and rows.dtype == torch.int32
    back = unpack_balanced(values, rows, (16, 8), 4, 2)
    assert back.dtype == torch.bfloat16
    keep = torch.kron(bmask.to(torch.int32), torch.ones(4, 2, dtype=torch.int32)).bool()
    assert torch.equal(back, torch.where(keep, w, torch.zeros((), dtype=w.dtype)))


# --------------------------------------------------------------------------- #
# CSR                                                                          #
# --------------------------------------------------------------------------- #


def _csr_case(name):
    rng = np.random.default_rng(5)
    w = _arr(rng, 24, 40)
    if name == "all-zero-mask":
        return w, np.zeros_like(w)
    if name == "dense":
        return w, np.ones_like(w)
    return w, (rng.random(w.shape) < 0.3).astype(np.float32)


@pytest.mark.parametrize("name", ["random-mask", "all-zero-mask", "dense"])
def test_csr_bit_equal_to_jax(name):
    w, m = _csr_case(name)
    got = CSR.from_dense(torch.from_numpy(w), torch.from_numpy(m))
    want = jformats.CSR.from_dense(w, m)
    for field in ("data", "indices", "indptr"):
        _eq(getattr(got, field), getattr(want, field))
    assert got.shape == want.shape
    assert got.nbytes == want.nbytes
    _eq(got.to_dense(), want.to_dense())
    np.testing.assert_array_equal(got.to_dense(), w * m)


def test_pbcsr_storage_beats_csr():
    """The paper's claim (the JAX package's ``test_pbcsr_storage_beats_csr``
    on the port): one int32 per block against one per element."""
    w = _arr(np.random.default_rng(6), 512, 512)
    wp, m = project(torch.from_numpy(w), Block(0.5, bm=128, bn=128))
    pb = PBCSR.from_dense(wp, m, 128, 128)
    csr = CSR.from_dense(wp, m)
    dense = dense_nbytes((512, 512), torch.float32)
    assert pb.nbytes < csr.nbytes < dense * 1.5
    assert pb.nbytes - pb.n_blocks * 128 * 128 * 4 == pb.n_blocks * 4
    # the same arrays through the JAX package: the same masks and bytes
    jwp, jm = jproject(jnp.asarray(w), JBlock(0.5, bm=128, bn=128))
    _eq(m, jm)
    jcsr = jformats.CSR.from_dense(np.asarray(jwp), np.asarray(jm))
    assert csr.nbytes == jcsr.nbytes
    assert pb.nbytes == jformats.PBCSR.from_dense(jwp, jm, 128, 128).nbytes
    assert bool(block_mask(m, 128, 128).sum() == pb.n_blocks)


# --------------------------------------------------------------------------- #
# the subpackages' exported names                                              #
# --------------------------------------------------------------------------- #

SUBPACKAGES = ["configs", "core", "core.graph", "core.pruning", "core.sparse", "data",
               "kernels", "launch", "models", "obs", "quant", "robustness", "serving",
               "training", "utils"]


def _bound_names(pkg: str, root: str):
    """The names a package's ``__init__`` binds by import, plus its
    ``__all__``."""
    path = ROOT / "src" / root / Path(*pkg.split(".")) / "__init__.py"
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom) and node.level > 0:
            names |= {a.asname or a.name for a in node.names}
    mod = importlib.import_module(f"{root}.{pkg}")
    names |= set(getattr(mod, "__all__", ()))
    return {n for n in names if not n.startswith("_")}, mod


@pytest.mark.parametrize("pkg", SUBPACKAGES)
def test_subpackage_exports_the_jax_packages_names(pkg):
    want, jmod = _bound_names(pkg, "repro")
    got, tmod = _bound_names(pkg, "repro_torch")
    missing = EXCEPTIONS.get(pkg, set())
    assert missing <= want  # the exceptions are JAX names
    assert got == want - missing, (sorted(want - missing - got), sorted(got - want))
    if hasattr(tmod, "__all__"):
        assert set(tmod.__all__) == got
    for name in sorted(got):
        assert _kind(getattr(tmod, name)) == _kind(getattr(jmod, name)), name


def _kind(v) -> str:
    """A callable module (the port's kernel modules) counts as a callable."""
    if callable(v):
        return "callable"
    return "module" if isinstance(v, types.ModuleType) else "value"


def test_kernel_names_stay_modules_and_call_the_ops_entry_points():
    from repro_torch import kernels
    from repro_torch.kernels import conv2d, ops

    import repro_torch.kernels.bsr_matmul as bsr_module

    assert isinstance(conv2d, types.ModuleType) and hasattr(conv2d, "conv2d_gemm")
    assert kernels.bsr_matmul is bsr_module
    rng = np.random.default_rng(7)
    x, w = torch.from_numpy(_arr(rng, 2, 3, 9, 9)), torch.from_numpy(_arr(rng, 4, 3, 3, 3))
    assert torch.equal(conv2d(x, w, stride=2, activation="relu"),
                       ops.conv2d(x, w, stride=2, activation="relu"))
    steps = (("add", 0),)
    a, b = torch.from_numpy(_arr(rng, 5, 8)), torch.from_numpy(_arr(rng, 5, 8))
    assert torch.equal(kernels.fused_elementwise(a, [b], steps),
                       ops.fused_elementwise(a, [b], steps))


LAZY = r"""
import sys
import repro_torch.training, repro_torch.launch, repro_torch.models, repro_torch.utils
loaded = [m for m in ("repro_torch.training.compression", "repro_torch.training.collective_matmul",
                      "repro_torch.launch.mesh", "torch.distributed.tensor") if m in sys.modules]
assert not loaded, loaded
from repro_torch.training import CompressionConfig, make_compressed_allreduce, ag_matmul
from repro_torch.launch import HW, make_mesh
assert "repro_torch.training.compression" in sys.modules and "repro_torch.launch.mesh" in sys.modules
print("ok")
"""


def test_mesh_exports_load_on_first_use():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", LAZY], env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
    import repro_torch.training as training

    with pytest.raises(AttributeError):
        training.no_such_name
