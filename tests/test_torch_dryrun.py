"""The port's dry run (``launch/dryrun.py``, ``utils/op_costs.py``) and
roofline (``launch/roofline.py``) on smoke cells of a fake (2, 2)
``(data, model)`` mesh, in one process: a ``"fake"`` process group and meta
tensors, nothing allocated.

* the train cell's FLOPs (all devices) within 2x of ``model_flops`` (6ND;
  remat's recompute puts the eager count near 8ND), its argument bytes equal
  to the local shards' bytes reckoned here from the specs (params, ZeRO-1
  f32 moments, the batch), collectives counted by kind, a peak of live bytes
  above the arguments;
* prefill and decode cells run; a cell that cannot run is recorded with
  ``ok: false`` and its error, as in JAX;
* ``analyze_record`` gives three terms and a dominant one; ``main`` writes
  the JAX package's field names; the roofline table lists the cells;
* deepseek-v2-lite-16b at full width under ``FSDP_RULES`` (train and
  decode, on (2, 2) and (4, 1)) runs, and qwen3-14b ``decode_32k`` on the
  16 x 16 mesh keeps its caches cut (live bytes, all-gather bytes);
* mamba2-1.3b and recurrentgemma-9b at full width on the 16 x 16 mesh run
  their mixers tensor-parallel over ``model``: per device FLOPs near the
  analytic count, no all-gather as large as one layer's local ``in_proj``
  shard, and decode caches kept where they lie; a ``model`` size that does
  not divide their heads or channels raises.  Every family's smoke cells:
  ``tests/test_torch_dryrun_grid.py``;
* the LM head keeps its logits split over the vocab whether or not the
  vocab needed padding: recurrentgemma-9b ``train_4k`` on the 16 x 16 mesh
  holds no more live bytes than JAX's dry run, a 3-layer cut of
  recurrentgemma-9b and deepseek-v2-lite-16b counts the same live and
  collective bytes at its vocab and one class fewer, and on 2 gloo ranks
  (``tests/_torch_mesh_ranks.py``, case ``vocab2``) a vocab-256 loss takes
  vocab-split logits and matches the unsharded loss and gradients.
"""

import dataclasses
import json
import math

import pytest
import torch

from repro_torch.configs import SHAPES as FULL_SHAPES
from repro_torch.configs import get_config, smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, roofline
from repro_torch.models import get_model
from repro_torch.models import sharding
from repro_torch.training.optimizer import zero1_pspecs
from repro_torch.utils.flops import meta_params
from repro_torch.utils.tree import leaves_with_path

MESH = ((2, 2), ("data", "model"))
SHAPES = {"train_4k": ShapeConfig("train_4k", 32, 8, "train"),
          "prefill_32k": ShapeConfig("prefill_32k", 64, 4, "prefill"),
          "decode_32k": ShapeConfig("decode_32k", 64, 4, "decode")}


def _cell(arch, shape, **kw):
    return dryrun.run_cell(arch, shape, "single", cfg_override=smoke_config(arch),
                           mesh_shape=MESH, shape_override=SHAPES[shape], verbose=False, **kw)


@pytest.fixture(scope="module")
def train_rec():
    return _cell("qwen2.5-3b", "train_4k")


def _local_bytes(tree, specs, dtype=None):
    """Bytes of rank 0's shards: a dim split over n ranks keeps
    ``ceil(size / n)`` (``torch.chunk``'s first chunk)."""
    sizes = dict(zip(*MESH[::-1]))
    total = 0
    for (_, leaf), (_, spec) in zip(leaves_with_path(tree), leaves_with_path(specs)):
        shape = list(leaf.shape)
        for d in range(len(shape)):
            for a in spec.axes(d):
                shape[d] = -(-shape[d] // sizes[a])
        total += math.prod(shape) * (dtype or leaf.dtype).itemsize
    return total


def test_train_cell_counts(train_rec):
    rec = train_rec
    assert rec["ok"], rec.get("error")
    assert rec["step"] == "train_step" and rec["chips"] == 4 and rec["rules"] == "default"
    assert rec["probes"].startswith("none")
    ratio = rec["cost"]["flops"] * rec["chips"] / rec["model_flops"]
    assert 0.5 < ratio < 2.0, ratio
    cfg = smoke_config("qwen2.5-3b")
    meta = meta_params(cfg)
    specs = sharding.param_pspecs(meta)
    moments = zero1_pspecs(specs, meta, data_size=2)
    _, batch, _ = get_model(cfg).input_specs(SHAPES["train_4k"])
    bspecs = {k: sharding.P("data", None) for k in batch}
    want = (_local_bytes(meta, specs) + 2 * _local_bytes(meta, moments, torch.float32)
            + _local_bytes(batch, bspecs))
    assert rec["memory"]["argument_bytes"] == want
    assert rec["memory"]["live_bytes"] > rec["memory"]["argument_bytes"]
    assert rec["memory"]["fits_hbm"]
    kinds = rec["collectives"]["per_kind"]
    assert rec["collectives"]["total_bytes"] == sum(kinds.values()) > 0
    assert set(kinds) <= {"all-gather", "reduce-scatter", "all-reduce", "all-to-all"}
    assert rec["cost"]["bytes_accessed"] > rec["memory"]["argument_bytes"]


@pytest.mark.parametrize("shape,step", [("prefill_32k", "prefill"), ("decode_32k", "serve_step")])
def test_serving_cells_run(shape, step):
    rec = _cell("qwen2.5-3b", shape)
    assert rec["ok"], rec.get("error")
    assert rec["step"] == step and rec["cost"]["flops"] > 0
    if step == "serve_step":  # the KV caches are arguments
        assert rec["memory"]["argument_bytes"] > 2 * 64 * 4 * smoke_config("qwen2.5-3b").d_model


def test_failed_cell_is_recorded():
    rec = dryrun.run_cell("qwen2.5-3b", "train_4k", "single",
                          cfg_override=smoke_config("qwen2.5-3b"),
                          mesh_shape=((4,), ("data",)), shape_override=SHAPES["train_4k"],
                          verbose=False)
    assert rec["ok"] is False and rec["error"] and "traceback" in rec


def test_roofline_of_the_cell(train_rec, tmp_path):
    a = roofline.analyze_record(train_rec)
    assert a["dominant"] in ("compute", "memory", "collective")
    assert a["dominant"] == max(("compute", "memory", "collective"),
                                key=lambda k: a[f"t_{k}_s"])
    assert 0 < a["useful_ratio"] < 10 and 0 < a["roofline_fraction"] <= 1
    with open(dryrun.cell_path(str(tmp_path), "qwen2.5-3b", "train_4k", "single"), "w") as f:
        json.dump(train_rec, f)
    md = tmp_path / "table.md"
    assert roofline.main(["--dir", str(tmp_path), "--md", str(md)]) == 0
    table = md.read_text()
    assert "| qwen2.5-3b | train_4k | train_step |" in table and "NVLink" in table
    for key in ("arch", "shape", "mesh", "status", "chips", "params_total", "params_active",
                "model_flops", "step", "memory", "cost", "collectives", "ok"):
        assert key in train_rec, key


# --------------------------------------------------------------------------- #
# full-width cells                                                             #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("mesh", [(2, 2), (4, 1)], ids=["2x2", "4x1"])
@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_full_width_moe_cell_under_fsdp(shape, mesh):
    """deepseek-v2-lite-16b at full width (27 layers, 64 experts) under
    ``FSDP_RULES``: the expert stacks carry a ``data`` shard of their rows,
    gathered for the expert products and reduce-scattered back."""
    rec = dryrun.run_cell("deepseek-v2-lite-16b", shape, "single",
                          mesh_shape=(mesh, ("data", "model")), shape_override=SHAPES[shape],
                          verbose=False, overrides={"rules": "fsdp"})
    assert rec["ok"], rec.get("error")
    assert rec["rules"] == "fsdp" and rec["memory"]["fits_hbm"]
    assert rec["cost"]["flops"] > 0


def test_decode_cell_on_the_production_mesh_keeps_its_caches_cut():
    """qwen3-14b ``decode_32k`` on the 16 x 16 mesh: the step holds at most
    twice its arguments live (new caches beside the old, no cache gathered:
    73.79 GB live against 4.53 GB of arguments before the caches kept their
    cut), and its all-gathers move less than one layer's cache shard."""
    rec = dryrun.run_cell("qwen3-14b", "decode_32k", "single", verbose=False)
    assert rec["ok"], rec.get("error")
    m = rec["memory"]
    assert m["argument_bytes"] < m["live_bytes"] < 2 * m["argument_bytes"]
    cfg = get_config("qwen3-14b")
    shape = FULL_SHAPES["decode_32k"]
    layer_shard = (shape.global_batch // 16) * (shape.seq_len // 16) * cfg.n_kv_heads * \
        cfg.resolved_head_dim * 2  # bf16 k of one layer on one device
    assert rec["collectives"]["per_kind"].get("all-gather", 0) < layer_shard


#: the JAX package's dry run of the same cells on the same fake 16 x 16
#: mesh (``python -m repro.launch.dryrun``, jax 0.9 on the CPU; ``PERF.md``
#: section 5): collective bytes a device of the two decode cells, and the
#: peak of live bytes of mamba2-1.3b ``train_4k``
JAX_COLLECTIVES = {("mamba2-1.3b", "decode_32k"): 6.64e6,
                   ("recurrentgemma-9b", "decode_32k"): 1.222e7}
JAX_LIVE = {("mamba2-1.3b", "train_4k"): 39.52e9,
            ("recurrentgemma-9b", "train_4k"): 72.0e9}


@pytest.mark.parametrize("arch,shape", [("mamba2-1.3b", "decode_32k"),
                                        ("mamba2-1.3b", "long_500k"),
                                        ("mamba2-1.3b", "train_4k"),
                                        ("recurrentgemma-9b", "decode_32k"),
                                        ("recurrentgemma-9b", "train_4k")])
def test_recurrent_mixers_are_tensor_parallel_on_the_production_mesh(arch, shape):
    """Each rank runs its 4 of mamba2's 64 heads, or 256 of the 4096
    RG-LRU channels: the FLOPs a device within 1.5x of the analytic count
    (2x for training, whose remat recomputes the forward; the batch of 1 of
    ``long_500k`` is not cut over ``data``, so its count is over the 16
    ``model`` ranks), all-gathers smaller than one layer's local ``in_proj``
    shard (the mixers' weights and recurrent states are never gathered:
    before, 2.059e8 and 2.732e8 bytes a decode step), at most 3x the JAX
    package's collective bytes, no more live bytes in training than JAX
    holds (recurrentgemma-9b: 272.3 GB before its unpadded 256000-class
    head kept the logits split over the vocab), and every decode cache leaf
    back in its ``cache_pspecs`` placement and local shape."""
    rec = dryrun.run_cell(arch, shape, "single", verbose=False)
    assert rec["ok"], rec.get("error")
    cfg = get_config(arch)
    chips, model = rec["chips"], rec["mesh_shape"]["model"]
    per_device = rec["model_flops"] / (model if shape == "long_500k" else chips)
    assert rec["cost"]["flops"] <= (2.0 if shape == "train_4k" else 1.5) * per_device
    if cfg.ssm:
        sc = cfg.ssm
        d_inner = sc.expand * cfg.d_model
        cols = 2 * d_inner + 2 * sc.n_groups * sc.d_state + d_inner // sc.head_dim
    else:
        cols = cfg.recurrent.lru_width
    in_proj_shard = cfg.d_model * -(-cols // model) * 2  # bf16
    kinds = rec["collectives"]["per_kind"]
    if shape == "train_4k":
        assert rec["memory"]["live_bytes"] <= JAX_LIVE[(arch, shape)]
        assert rec["memory"]["fits_hbm"]
        return
    assert rec["caches_kept"]
    assert kinds.get("all-gather", 0) < in_proj_shard
    if (arch, shape) in JAX_COLLECTIVES:
        assert rec["collectives"]["total_bytes"] <= 3 * JAX_COLLECTIVES[(arch, shape)]


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
@pytest.mark.parametrize("arch,what", [("mamba2-1.3b", "the 8 Mamba-2 heads"),
                                       ("recurrentgemma-9b", "the 128 RG-LRU channels")])
def test_mixer_cut_that_does_not_divide_raises(arch, what, shape):
    """A ``model`` size that does not divide the mixer's heads or channels
    (3 ranks: 8 heads, 128 channels in the smoke configs) raises, naming the
    arch, the mesh dim and the mesh; no path gathers the mixer whole."""
    rec = dryrun.run_cell(arch, shape, "single", cfg_override=smoke_config(arch),
                          mesh_shape=((1, 3), ("data", "model")), shape_override=SHAPES[shape],
                          verbose=False)
    assert rec["ok"] is False
    assert rec["error"] == (f"ValueError: {arch}-smoke: {what} do not divide over the 3 ranks "
                            "of mesh dim 'model' of the mesh {'data': 1, 'model': 3}")


# --------------------------------------------------------------------------- #
# the head's vocab split                                                       #
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "deepseek-v2-lite-16b"])
def test_unpadded_vocab_keeps_the_head_split(arch):
    """``train_4k`` on the 16 x 16 mesh, cut to 3 layers: at the config's
    own vocab (256000 and 102400, no padding) and at one class fewer
    (padded to the next 256), the live and the collective bytes a device
    agree within 5%.  Before the head kept its logits split, the unpadded
    head's logits were a partial sum of every class on each device: 251.41
    against 36.56 GiB live (recurrentgemma-9b), 100.60 against 14.66
    (deepseek-v2-lite-16b)."""
    base = get_config(arch)
    recs = []
    for vocab in (base.vocab, base.vocab - 1):
        cfg = dataclasses.replace(base, n_layers=3, vocab=vocab)
        rec = dryrun.run_cell(arch, "train_4k", "single", cfg_override=cfg, verbose=False)
        assert rec["ok"], rec.get("error")
        recs.append(rec)
    assert recs[0]["memory"]["live_bytes"] == pytest.approx(recs[1]["memory"]["live_bytes"],
                                                            rel=0.05)
    assert recs[0]["collectives"]["total_bytes"] == pytest.approx(
        recs[1]["collectives"]["total_bytes"], rel=0.05)


def test_unpadded_vocab_loss_is_vocab_parallel(tmp_path):
    """A vocab-256 smoke loss on a (1, 2) mesh of 2 gloo ranks, its residual
    stream cut over the batch on ``model`` too, 8 x 128 tokens against the
    head's 256 x 64 table (where DTensor's own choice for the head is to
    contract over ``D`` and leave every class's logits on each rank): the
    logits reach the cross entropy split over the vocab on ``model``
    (``Shard(2)``), and the loss (within 1e-5) and every gradient leaf
    (within 1e-4 x its max) match the unsharded step's."""
    import numpy as np

    from test_torch_distributed import _finish, _start_ranks

    np.savez(tmp_path / "inputs.npz", none=np.zeros(1))
    _finish({"vocab2": _start_ranks("vocab2", 2, tmp_path)})
    out = dict(np.load(tmp_path / "vocab2_rank0.npz"))
    assert list(out["vocab2_placements"]) == ["(Shard(dim=0), Shard(dim=2))"], \
        out["vocab2_placements"]
    plain, sharded = out["vocab2_loss"]
    assert sharded == pytest.approx(plain, rel=1e-5)
    assert out["vocab2_grad_err"].max() <= 1e-4, out["vocab2_grad_err"]
