"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import neither
JAX nor the JAX package, its entry points default to CUDA and raise without
a GPU instead of running on the CPU, and no kernel is built at import."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.convert import params_from_numpy, resolve_device
from repro_torch.core.graph import GraphBuilder, compile_plan
from repro_torch.kernels import conv2d as tconv
from repro_torch.kernels import dense_matmul as tdense
from repro_torch.kernels import fused_elementwise as tfused
from repro_torch.launch import serve as tserve
from repro_torch.models import cnn as tcnn

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")

IMPORT_ALL = r"""
import importlib, importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"the port must not import {name}")
        return None

sys.meta_path.insert(0, Block())
import repro_torch
names = ["repro_torch"]
for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(info.name)
    names.append(info.name)
assert not any(m.split(".")[0] in ("jax", "jaxlib", "repro") for m in sys.modules)
from repro_torch.kernels import _build
assert _build._LIB is None, "a kernel library was loaded at import"
print(len(names), "modules")
"""


def test_every_module_imports_with_jax_and_repro_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", IMPORT_ALL], env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    n = int(res.stdout.split()[0])
    assert n == len(list(PKG.rglob("*.py")))  # every file is a module that imported


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax_and_no_jax_package(path):
    bad = sorted({r for r in _imported_roots(path) if r in FORBIDDEN})
    assert not bad, f"{path} imports {bad}"


def _tiny_graph():
    b = GraphBuilder(["x"])
    out = b.add("activation", "x", name="act", fn="relu")
    return b.build(out)


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_gpu(no_gpu):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compile_plan(_tiny_graph())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({"n": {"w": np.zeros(3, np.float32)}})
    for build in tcnn.APPS.values():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build(base=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--graph-app", "coloring", "--size", "8", "--base", "4", "--frames", "1"])
    # asking for the CPU explicitly is the only way onto it
    assert compile_plan(_tiny_graph(), device="cpu").device.type == "cpu"


def test_wrappers_refuse_devices_without_a_kernel():
    x = torch.empty(4, 3, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        tdense.dense_matmul(x, torch.empty(3, 2, device="meta"))
    with pytest.raises(ValueError, match="no kernel for device"):
        tfused.fused_elementwise(x, [x], (("add", 0),))
    with pytest.raises(ValueError, match="no kernel for device"):
        tconv.conv2d_gemm(torch.empty(1, 2, 5, 5, device="meta"),
                          torch.empty(3, 2, 3, 3, device="meta"))
    with pytest.raises(ValueError, match="several devices"):
        tdense.dense_matmul(torch.zeros(4, 3), torch.empty(3, 2, device="meta"))


def test_chip_smoke_alone_exits_nonzero_without_a_result(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, PYTHONPATH=""))
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
