"""The training launcher on every family of the zoo, on the CPU: the port's
``launch.train.train`` against the JAX launcher's loop, and the CLI for all
ten archs.

Per family (qk_norm, MLA + MoE with and without q-LoRA, the VLM, Mamba-2,
the RG-LRU hybrid, Whisper; f32 smoke configs, one numpy tree shared by both
packages) the launcher runs ``--steps 6 --batch 2 --seq 16 --prune
--admm-every 2`` -- 4 ADMM steps with Z/U updates after steps 1 and 3, the
hard prune after step int(6 * 0.6) = 3, 2 masked steps -- and the JAX
package runs the same loop (``repro.launch.train.main``'s, jitted).  Held:

* every step's loss and primal residual within rtol 1e-3 (at step 1
  Adam's ``g / (|g| + eps)`` can turn a gradient element at rounding level
  into a full step of either sign, which feeds later steps); the same
  steps update Z / U; the masked steps' loss is the ce (plus the router aux
  for MoE) with no penalty;
* the hard-prune masks bit-equal to JAX's, leaf by leaf, and the sparsity
  report equal: no expert stack among them (dense in both packages),
  none at all for Mamba-2 (``pruned_global`` 0.0 in both);
* ``python -m repro_torch.launch.train --arch <a> --smoke ...`` runs for
  every arch of ``ARCH_IDS`` and prints the JAX launcher's lines.  The CLI
  tests give the straggler monitor (``training.fault_tolerance``) a steady
  fake clock, so its count depends on the code and not on the machine's
  load: every step takes the same time, or the last one is made slow.
"""

import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pruning as jpr
from repro.data.pipeline import SyntheticPipeline as JPipeline
from repro.launch.train import default_prune_plan as jdefault_plan
from repro.training import optimizer as jopt
from repro.training.train_loop import TrainState as JTrainState
from repro.training.train_loop import init_train_state as jinit_state
from repro_torch.configs import ARCH_IDS
from repro_torch.launch import train as tlaunch
from repro_torch.training import fault_tolerance
from repro_torch.utils.tree import leaves_with_path
from test_torch_zoo_models import zoo_case
from test_torch_zoo_training import ADMM, ZOO, fresh_params, jax_step

ARGV = ["--smoke", "--steps", "6", "--batch", "2", "--seq", "16", "--prune", "--admm-every",
        "2", "--device", "cpu"]
STEPS, EVERY, HARD_AT = 6, 2, 3


def _jax_run(arch, args):
    """The JAX launcher's loop on ``arch``'s numpy tree: per step (loss, ce,
    residual), the update steps, the hard prune's masks and report."""
    c = zoo_case(arch)
    pipe = JPipeline(c["jcfg"], batch=args.batch, seq=args.seq + 1, seed=args.seed)
    opt = jopt.AdamWConfig(lr=args.lr, total_steps=args.steps,
                           warmup_steps=max(args.steps // 20, 5))
    assert opt == jopt.AdamWConfig(lr=1e-3, total_steps=STEPS, warmup_steps=5)
    state = jinit_state(c["jparams"], opt, admm_cfg=jpr.AdmmConfig(update_every=EVERY, **ADMM),
                        prune_plan=jdefault_plan(args.sparsity))
    step_fn = jax_step(arch, every=EVERY)
    out, updates = [], []
    for step in range(args.steps):
        n = int(state.admm.n_updates) if state.admm is not None else None
        state, m = step_fn(state, {k: jnp.asarray(v) for k, v in pipe.next().items()})
        out.append({k: float(v) for k, v in m.items()})
        updates.append(n is not None and int(state.admm.n_updates) > n)
        if step == HARD_AT:
            pruned, masks = jpr.hard_prune(state.params, state.admm)
            state = JTrainState(params=pruned, opt=state.opt, admm=None, masks=masks)
            step_fn = jax_step(arch)
            rep = jpr.tree_sparsity_report(pruned, masks)
            jmasks = masks
    return dict(metrics=out, updates=updates, masks=jmasks, report=rep)


_RUNS = {}


def runs(arch):
    """Both launchers' runs of ``arch`` (once per test process)."""
    if arch not in _RUNS:
        args = tlaunch.build_parser().parse_args(["--arch", arch] + ARGV)
        logs = []
        port = tlaunch.train(args, zoo_case(arch)["cfg"], fresh_params(arch),
                             torch.device("cpu"), log=logs.append)
        _RUNS[arch] = dict(args=args, port=port, logs=logs, jax=_jax_run(arch, args))
    return _RUNS[arch]


@pytest.mark.parametrize("arch", ZOO)
def test_launcher_trajectory_matches_jax(arch):
    r = runs(arch)
    hist, jm = r["port"]["history"], r["jax"]["metrics"]
    assert [h["phase"] for h in hist] == ["admm"] * (HARD_AT + 1) + ["masked"] * (
        STEPS - HARD_AT - 1)
    assert [h["update"] for h in hist] == r["jax"]["updates"] == [
        (i + 1) % EVERY == 0 and i <= HARD_AT for i in range(STEPS)]
    assert r["port"]["n_updates"] == 2
    for h, j in zip(hist, jm):
        assert set(h) - {"step", "phase", "update", "ms"} == set(j), h["step"]
        for k in ("loss", "ce", "primal_residual"):
            np.testing.assert_allclose(h.get(k, 0.0), j.get(k, 0.0), rtol=1e-3, atol=1e-7,
                                       err_msg=f"step {h['step']} {k}")
    cfg = zoo_case(arch)["cfg"]
    aux_w = cfg.moe.router_aux_weight if cfg.moe else 0.0
    for h in hist:
        if h["phase"] == "masked":  # no ADMM penalty: ce (+ the MoE aux)
            np.testing.assert_allclose(h["loss"], h["ce"] + aux_w * h.get("aux", 0.0),
                                       rtol=2e-6)
        if cfg.moe:
            assert np.isfinite(h["aux"]) and h["aux"] > 0


@pytest.mark.parametrize("arch", ZOO)
def test_launcher_hard_prune_masks_bit_equal_jax(arch):
    r = runs(arch)
    got = dict(leaves_with_path(r["port"]["masks"]))
    want = {p: np.asarray(m) for p, m in _keyed(r["jax"]["masks"])}
    assert got.keys() == want.keys()
    for path, m in got.items():
        assert m.dtype == torch.float32 and str(want[path].dtype) == "float32", path
        np.testing.assert_array_equal(m.numpy(), want[path], err_msg=path)
    assert not [p for p in got if "['experts']" in p]  # expert stacks stay dense
    rep, jrep = r["port"]["sparsity"], r["jax"]["report"]
    assert rep["per_leaf"] == {k: tuple(int(x) for x in v) for k, v in jrep["per_leaf"].items()}
    assert rep["pruned_global"] == float(jrep["pruned_global"])
    if zoo_case(arch)["cfg"].ssm is not None:  # the recipe matches no Mamba-2 leaf
        assert not got and rep["pruned_global"] == 0.0
    else:
        assert rep["pruned_global"] == pytest.approx(0.5, abs=0.05)


def _keyed(tree):
    return [(jax.tree_util.keystr(p), m) for p, m in jax.tree_util.tree_flatten_with_path(tree)[0]]


#: the JAX launcher's lines, as ``repro.launch.train.main`` prints them
_STEP_LINE = re.compile(r"^step +\d+ loss=-?\d+\.\d{4} ce=-?\d+\.\d{4} residual=\d+\.\d{3} "
                        r"\(\d+\.\d{2}s\)$")


class _SteadyClock:
    """``time.monotonic`` for the straggler monitor: each call advances by
    ``step`` seconds, the calls listed in ``slow`` by ``slow_step``."""

    def __init__(self, step=0.05, slow=(), slow_step=1.0):
        self.t, self.calls, self.step, self.slow, self.slow_step = 100.0, 0, step, slow, slow_step

    def monotonic(self):
        self.calls += 1
        self.t += self.slow_step if self.calls in self.slow else self.step
        return self.t


def _fake_clock(monkeypatch, **kw):
    clock = _SteadyClock(**kw)
    monkeypatch.setattr(fault_tolerance, "time", types.SimpleNamespace(monotonic=clock.monotonic))
    return clock


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cli_trains_every_arch_and_prints_the_jax_lines(arch, capsys, monkeypatch):
    clock = _fake_clock(monkeypatch)
    rep = tlaunch.main(["--arch", arch] + ARGV)
    assert clock.calls == 2 * STEPS  # one start and one end a step
    lines = capsys.readouterr().out.splitlines()
    sparsity = 0.0 if arch == "mamba2-1.3b" else 0.5
    assert [ln.split()[1] for ln in lines if ln.startswith("step")] == ["0", "5"]
    assert all(_STEP_LINE.match(ln) for ln in lines if ln.startswith("step")), lines
    assert f"  [hard prune] global sparsity over pruned leaves: {sparsity:.3f}; masked " \
           f"fine-tune begins" in lines
    assert lines[-1].startswith("done; median step ") and lines[-1].endswith("stragglers: 0")
    assert len(lines) == 4
    assert np.isfinite([h["loss"] for h in rep["history"]]).all()
    assert rep["n_updates"] == 2 and rep["param_counts"]["total"] > 0


def test_cli_reports_a_slow_last_step_as_a_straggler(capsys, monkeypatch):
    """The same CLI with the fake clock making step 6 (the 12th reading, its
    end) take 1 s against the others' 0.05 s: the monitor flags it, and the
    CLI prints one straggler line and ends in ``stragglers: 1``."""
    clock = _fake_clock(monkeypatch, slow=(2 * STEPS,))
    tlaunch.main(["--arch", ARCH_IDS[0]] + ARGV)
    lines = capsys.readouterr().out.splitlines()
    assert clock.calls == 2 * STEPS
    assert [ln for ln in lines if "[straggler]" in ln] == [
        "  [straggler] step 6: 1.00s vs median 0.05s"]
    assert lines[-1] == "done; median step 0.05s, stragglers: 1"
    assert len(lines) == 5
