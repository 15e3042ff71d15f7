"""``tests/_torch_mesh_ranks.py``'s ``zoo4`` and ``ssm4`` cases on the
installed torch: 4 gloo ranks on the CPU each, every family's smoke config
(``ssm4``: the Mamba-2 and RG-LRU ones, tensor-parallel over ``model`` on
(1, 4) and (2, 2)) with the port's own seeded init (no JAX needed), checked
against the unsharded numbers with ``tests/test_torch_distributed_zoo.py``'s
and ``tests/test_torch_distributed_ssm.py``'s tolerances: the train step,
the sharded prefill (its logits, caches and their placements), the decode
steps from its caches and, in ``zoo4``, the ``Engine`` and the
``RequestScheduler`` on the mesh.  Prints
the worst loss / gradient / prefill / logit errors of each case and PASS or
FAIL (exit 1).  Use
it to run the mesh paths on another PyTorch than the test suite's (DTensor's
view and einsum rules differ between versions).

    python tools/zoo4_compat.py      # logs and results in build/compat_zoo/
"""
import os, shutil, subprocess, sys, time
import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tests"))
print("compat:", sys.version.split()[0], torch.__version__, flush=True)
io = os.path.join(ROOT, "build", "compat_zoo")
shutil.rmtree(io, ignore_errors=True)
os.makedirs(io)
from repro_torch.configs import ARCH_IDS, smoke_config
from repro_torch.models import get_model
from repro_torch.training import checkpoint

for i, arch in enumerate(ARCH_IDS):
    checkpoint.save(os.path.join(io, f"params_{arch}"), 0,
                    get_model(smoke_config(arch), device="cpu").init(torch.Generator().manual_seed(i)))
np.savez(os.path.join(io, "inputs.npz"), none=np.zeros(1))
env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))


def run(case):
    """The case's 4 ranks; its rank 0 results, or None (the log printed)."""
    t0 = time.time()
    logs = [open(os.path.join(io, f"{case}_rank{r}.log"), "w") for r in range(4)]
    ps = [subprocess.Popen([sys.executable, os.path.join(ROOT, "tests", "_torch_mesh_ranks.py"),
                            case, str(r), "4", io], env=env, stdout=logs[r],
                           stderr=subprocess.STDOUT) for r in range(4)]
    rcs = []
    for p in ps:
        try:
            rcs.append(p.wait(timeout=600))
        except subprocess.TimeoutExpired:
            rcs.append("timeout")
    for p in ps:
        if p.poll() is None:
            p.kill()
    for f in logs:
        f.close()
    print(f"compat {case}: rcs {rcs} in {time.time() - t0:.1f}s", flush=True)
    if rcs != [0] * 4:
        print(open(os.path.join(io, f"{case}_rank0.log")).read()[-6000:])
        return None
    return dict(np.load(os.path.join(io, f"{case}_rank0.npz")))


import _torch_mesh_ranks as ranks


def check(case, o, archs, meshes, ssm=False):
    """Worst errors over ``archs`` x ``meshes`` x rule sets; the failing tags."""
    bad, worst = [], {"loss": 0.0, "grad": 0.0, "prefill": 0.0, "logits": 0.0}
    for arch in archs:
        mixer = np.char.find(o[arch + "_paths"], "['mixer']") >= 0
        for a, b in meshes:
            for rules in ranks.ZOO_RULES:
                t = f"{arch}_{a}x{b}_{rules}"
                le = abs(float(o[t + "_loss"]) - float(o[arch + "_loss"])) / abs(float(o[arch + "_loss"]))
                ge = float((o[t + "_grad_err"] / np.maximum(o[arch + "_grad_max"], 1e-30)).max())
                lg = o[arch + "_logits"]
                de = float(np.abs(o[t + "_logits"] - lg).max() / np.abs(lg).max())
                pe, placed = 0.0, True
                if t + "_prefill_err" in o:  # every decoder family
                    pe = max(float(o[t + "_prefill_err"]), float(o[t + "_prefill_cache_err"].max()))
                    placed = bool(o[t + "_prefill_placed"].all())
                worst = {"loss": max(worst["loss"], le), "grad": max(worst["grad"], ge),
                         "prefill": max(worst["prefill"], pe), "logits": max(worst["logits"], de)}
                kept = bool(o[t + "_kept"].all()) and placed
                if ssm:  # the weights, and the mixers' gradients, in their placements
                    kept = kept and bool(o[t + "_weights_kept"]) and bool(
                        o[t + "_grad_cut"][mixer].all())
                if le > 1e-5 or ge > 1e-4 or pe > 1e-5 or de > 1e-5 or not kept:
                    bad.append((t, le, ge, pe, de, kept))
    print(f"compat {case}: worst loss rel {worst['loss']:.2e}, grad {worst['grad']:.2e} x max, "
          f"prefill {worst['prefill']:.2e} x max, logits {worst['logits']:.2e} x max; every "
          f"cache leaf in place: {not any(not x[-1] for x in bad)}", flush=True)
    return bad


def check_engine(o):
    """The ``Engine`` on the mesh: the greedy tokens equal to the unsharded
    engine's (or, at the first step that differs, a near tie of the plain
    logits), every cache leaf kept after each step."""
    bad = []
    for arch in ranks.ENGINE_ARCHS:
        (plain, sharded), logits = o[arch + "_engine_tokens"], o[arch + "_engine_logits"]
        differ = np.flatnonzero((plain != sharded).any(axis=0))
        ok = bool(o[arch + "_engine_kept"].all())
        if differ.size:
            top2 = np.sort(logits[differ[0]], axis=-1)[:, -2:]
            ok = ok and bool(((top2[:, 1] - top2[:, 0]) <= 1e-5 * np.abs(logits[differ[0]]).max()).all())
        print(f"compat zoo4: engine {arch}: tokens {'equal' if not differ.size else 'differ'}",
              flush=True)
        if not ok:
            bad.append(("engine", arch))
    return bad


def check_scheduler(o):
    """The ``RequestScheduler`` on the mesh: each request's tokens equal to
    the unsharded scheduler's (or, at its first token that differs, a near
    tie of the plain logits), every request served, every cache leaf in its
    ``cache_pspecs`` placements with half the batch a rank at each tick."""
    bad = []
    for arch, rules in ranks.SCHED_CELLS:
        t = f"{arch}_{rules}"
        plain, got, logits = o[arch + "_sched_tokens"], o[t + "_sched_tokens"], o[arch + "_sched_logits"]
        ok = bool(o[t + "_sched_done"].all() and o[t + "_sched_placed"].all()
                  and o[t + "_sched_rows"].all()) and ((plain == -1) == (got == -1)).all()
        for r in np.flatnonzero((plain != got).any(axis=1)):
            k = np.flatnonzero(plain[r] != got[r])[0]
            top2 = np.sort(logits[r, k])[-2:]
            ok = ok and bool(top2[1] - top2[0] <= 1e-5 * np.abs(logits[r, k]).max())
        print(f"compat zoo4: scheduler {t}: tokens {'equal' if (plain == got).all() else 'differ'}"
              f", {len(o[t + '_sched_placed'])} ticks in place", flush=True)
        if not ok:
            bad.append(("scheduler", t))
    return bad


bad = []
o = run("zoo4")
if o is None:
    bad.append("zoo4 did not run")
else:
    bad += check("zoo4", o, ARCH_IDS, ranks.ZOO_MESHES)
    bad += check_engine(o)
    bad += check_scheduler(o)
    y = o["window_y"]
    we = float(np.abs(y[:, 1] - y[:, 0]).max() / np.abs(y[:, 0]).max())
    print(f"compat zoo4: window {we:.2e}", flush=True)
    if we > 1e-5 or not o["window_kept"].all():
        bad.append(("window", we))
o = run("ssm4")
if o is None:
    bad.append("ssm4 did not run")
else:
    bad += check("ssm4", o, ranks.SSM_ARCHS, ranks.SSM_MESHES, ssm=True)
print("compat:", "PASS" if not bad else f"FAIL {bad}", flush=True)
sys.exit(0 if not bad else 1)
