"""The port's ``launch/tune`` CLI on the CPU (``--device cpu --smoke``): the
JSON it writes (``|cpu`` keys of every swept family, loadable by the JAX
package's ``TuningCache``), its ``--ops`` filter, and ``launch/serve``
serving on the loaded winners through ``REPRO_TUNE_CACHE``."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.kernels.ops import TuningCache as JTuningCache
from repro_torch.kernels import ops as tops
from repro_torch.launch import tune as ttune

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def fresh_cache():
    cache = tops.tuning_cache()
    state = (cache.enabled, dict(cache.entries), cache.sweeps, dict(cache.stats),
             cache.ops_filter)
    cache.clear()
    yield cache
    (cache.enabled, cache.entries, cache.sweeps, cache.stats, cache.ops_filter) = state


def _tune(tmp_path, *extra):
    out = tmp_path / "tune.json"
    ttune.main(["--device", "cpu", "--smoke", "--graph-app", "coloring", "--out", str(out),
                *extra])
    return out, json.loads(out.read_text())


def test_cli_writes_swept_cpu_keys_that_the_jax_cache_loads(tmp_path, fresh_cache, capsys):
    out, payload = _tune(tmp_path, "--quantize")
    text = capsys.readouterr().out
    assert payload["version"] == 1
    entries = payload["entries"]
    ops = {k.split("|")[0] for k in entries}
    assert {"matmul", "qmatmul", "conv2d"} <= ops
    assert all(k.endswith("|cpu") for k in entries)
    assert all(e["source"] == "swept" and e["ms"] > 0 for e in entries.values())
    assert any(k.split("|")[2] == "int8" for k in entries)  # the W8A8 keys
    # the CLI's lines: report, stats report, summary
    assert "op,shape,dtype,format,mode,blocks,source,ms" in text
    assert "family,hits,misses,sweeps" in text
    last = text.strip().splitlines()[-1]
    assert last == (f"tune: {fresh_cache.sweeps} sweeps, {len(fresh_cache.entries)} keys -> "
                    f"{out}")
    jc = JTuningCache(enabled=False, path=str(out))
    assert set(jc.entries) == set(entries)
    assert all(e.source == "loaded" for e in jc.entries.values())


def test_cli_ops_filter_sweeps_only_that_family(tmp_path, fresh_cache, capsys):
    _, payload = _tune(tmp_path, "--ops", "conv2d")
    capsys.readouterr()
    assert payload["entries"] and {k.split("|")[0] for k in payload["entries"]} == {"conv2d"}
    assert fresh_cache.stats["matmul"]["sweeps"] == 0
    assert fresh_cache.stats["conv2d"]["sweeps"] > 0
    # the excluded family still resolved (to its default, not persisted)
    assert any(k.startswith("matmul|") and e.source == "default"
               for k, e in fresh_cache.entries.items())


def test_serve_runs_on_the_loaded_winners(tmp_path, fresh_cache, capsys):
    """``REPRO_TUNE_CACHE=path python -m repro_torch.launch.serve`` at the
    tuned shapes: every GEMM and conv key the plan resolves is a loaded
    winner (hits, no misses)."""
    out, payload = _tune(tmp_path)
    capsys.readouterr()
    code = (
        "from repro_torch.kernels import ops\n"
        "from repro_torch.launch import serve\n"
        "c = ops.tuning_cache()\n"
        "assert c.entries and all(e.source == 'loaded' for e in c.entries.values())\n"
        "serve.main(['--graph-app', 'coloring', '--size', '16', '--base', '8', '--frames', '2',"
        " '--device', 'cpu'])\n"
        "print('STATS', {f: c.stats.get(f) for f in ('matmul', 'conv2d')})\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), REPRO_TUNE_CACHE=str(out))
    env.pop("REPRO_TUNE", None)
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    stats = eval(res.stdout.split("STATS", 1)[1])  # noqa: S307 -- our own dict literal
    for fam in ("matmul", "conv2d"):
        assert stats[fam]["hits"] > 0 and stats[fam]["misses"] == 0, stats
    assert json.loads(out.read_text()) == payload  # serving does not write the file
