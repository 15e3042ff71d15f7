"""Mesh dry run: build every (architecture x input shape x mesh) cell's step
on a fake process group of the mesh's size and count what one device does
(a port of ``repro.launch.dryrun``).

For each cell the JAX package lowers and compiles the step against its
production mesh with ``ShapeDtypeStruct`` inputs.  Here the step runs
eagerly in one process on a ``"fake"`` process group (``FakeStore``) of the
mesh's world size: params, ZeRO-1 moments, the batch and the decode caches
are DTensors whose local shards lie on the meta device, placed by the
sharding rules, so nothing is allocated, and ``utils.op_costs.OpCosts``
counts one device's local ops -- the technique of torchtitan's memory
estimator, with meta tensors where it takes ``FakeTensorMode`` (DTensor's
strided-shard offsets call ``tolist`` on a fake tensor).

Per device it records argument bytes (the local shards), the peak of live
bytes and whether it fits a card's HBM, FLOPs, bytes accessed (inputs plus
outputs of every aten op: no fusion in eager PyTorch), collective bytes by
kind (from the collectives DTensor issues), plus the analytic
``model_flops`` and parameter counts (``utils.flops``); a decode cell also
records whether every cache leaf came back in the placements and local
shape it was given (``caches_kept``).

XLA's cost analysis counts a while-loop body once, so the JAX package
reconstructs its counts from 1- and 2-unit probes.  Eager PyTorch runs
every layer, so the counts are whole: ``probes`` is ``"none"``.

Steps, as in JAX: ``train_step`` (value and grad with ``remat``, AdamW
with ZeRO-1 moments), ``prefill`` (``forward``) and ``serve_step``
(``decode_step`` on caches batch-sharded over the data axes, their long
axis over ``model``).  ``FSDP_RULES`` are taken when the TP-only weight
shards would exceed a quarter of HBM.

Per cell -> ``build/dryrun/<arch>__<shape>__<mesh>.json`` with the JAX
package's field names (``trace_s`` is the fake run's wall time where JAX
records lower / compile seconds); a cell that fails is recorded with
``ok: false`` and its error.  ``launch/roofline.py`` reads them.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all [--force]
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs import ARCH_IDS, SHAPES, get_config, shape_cells
from ..configs.base import ArchConfig, ShapeConfig
from ..models import get_model
from ..models import encdec as encdec_mod
from ..models import transformer as lm
from ..models.sharding import (
    FSDP_RULES,
    P,
    _maybe_replicate_batch,
    batch_spec,
    cache_pspecs,
    is_dtensor,
    mesh_context,
    param_placements,
    param_pspecs,
)
from ..training.optimizer import AdamWConfig, AdamWState, adamw_update, zero1_pspecs
from ..training.train_loop import TrainState, _value_and_grad
from ..utils.flops import meta_params, model_flops, param_counts
from ..utils.op_costs import OpCosts
from ..utils.tree import leaves, map_with_path, tree_map
from .mesh import HW

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "build", "dryrun")

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}

PROBES = "none: eager PyTorch runs every layer, so the counts are whole"


# --------------------------------------------------------------------------- #
# sharding for inputs (the caches': ``sharding.cache_pspecs``)                #
# --------------------------------------------------------------------------- #


def _batch_pspecs(batch_tree: Any, bspec: P) -> Any:
    return tree_map(lambda leaf: P(bspec[0] if len(bspec) else None,
                                   *([None] * (leaf.ndim - 1))), batch_tree)


# --------------------------------------------------------------------------- #
# one configuration on the fake mesh                                           #
# --------------------------------------------------------------------------- #


def _data_size(mesh) -> int:
    names = mesh.mesh_dim_names
    return math.prod(mesh.size(names.index(a)) for a in ("pod", "data") if a in names)


def _meta_distribute(tree, specs, mesh):
    """Meta DTensors of ``tree``'s shapes, placed by ``specs``."""
    from torch.distributed.tensor import distribute_tensor

    def place(_, leaf, spec):
        full = torch.empty(leaf.shape, dtype=leaf.dtype, device="meta")
        return distribute_tensor(full, mesh, param_placements(mesh, spec), src_data_rank=None)

    return map_with_path(place, tree, specs)


def _rules(cfg: ArchConfig, counts, mesh, override=None):
    """``FSDP_RULES`` when TP-only bf16 weight shards exceed HBM / 4."""
    if override is not None:
        return {"default": None, "fsdp": FSDP_RULES}[override] if isinstance(override, str) \
            else override
    per_gpu_tp = counts["total"] * 2 / mesh.size(mesh.mesh_dim_names.index("model"))
    return FSDP_RULES if per_gpu_tp > HW.HBM_BYTES / 4 else None


def _run_step(cfg: ArchConfig, shape: ShapeConfig, mesh, *, zero1: bool, remat: bool,
              overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Build the cell's step on meta DTensors and count one device's run."""
    overrides = overrides or {}
    model = get_model(cfg)
    meta = meta_params(cfg)
    counts = param_counts(cfg, meta)
    rules = _rules(cfg, counts, mesh, overrides.get("rules"))
    p_specs = param_pspecs(meta, rules)
    bspec = batch_spec(mesh)
    step_name, batch_meta, cache_meta = model.input_specs(shape)
    b_specs = _maybe_replicate_batch(_batch_pspecs(batch_meta, bspec), batch_meta, mesh)

    costs = OpCosts()
    t0 = time.time()
    params = _meta_distribute(meta, p_specs, mesh)
    batch = _meta_distribute(batch_meta, b_specs, mesh)
    args = [params, batch]
    if step_name == "train_step":
        opt_cfg = AdamWConfig()
        mv = zero1_pspecs(p_specs, meta, data_size=_data_size(mesh)) if zero1 else p_specs
        # adamw_init's moments, on the meta device
        moments = tree_map(lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta"),
                           meta)
        opt = AdamWState(0, _meta_distribute(moments, mv, mesh),
                         _meta_distribute(moments, mv, mesh))
        args.append(opt)
        if cfg.is_encdec:
            def loss(p, b):
                return encdec_mod.loss_fn(p, cfg, b, remat=remat)
        else:
            def loss(p, b):
                return lm.loss_fn(p, cfg, b, remat=remat,
                                  remat_policy=overrides.get("remat_policy", "full"),
                                  residual_spec=overrides.get("residual_spec"))

        def fn():
            _, _, grads = _value_and_grad(loss, TrainState(params, opt), batch)
            return adamw_update(grads, opt, params, opt_cfg)[:2]
    elif step_name == "prefill":
        def fn():
            if cfg.is_encdec:
                return model.forward(params, batch)
            return lm.forward(params, cfg, batch["tokens"], patch_embeds=batch.get("patch_embeds"),
                              residual_spec=overrides.get("residual_spec"),
                              attn_chunk=overrides.get("attn_chunk", 1024))[0]
    else:
        c_specs = cache_pspecs(cache_meta, mesh)
        caches = _meta_distribute(cache_meta, c_specs, mesh)
        args.append(caches)

        def fn():
            with mesh_context(params, batch, caches):
                return model.decode_step(params, batch, caches)

    arg_tensors = [t for t in leaves(args) if isinstance(t, torch.Tensor)]
    with costs:
        arg_bytes = costs.track(arg_tensors)
        out = fn()
        out_tensors = [t for t in leaves(out) if isinstance(t, torch.Tensor)]
        ids = {id(_local(t).untyped_storage()) for t in arg_tensors}
        alias = sum(_local(t).untyped_storage().nbytes() for t in out_tensors
                    if id(_local(t).untyped_storage()) in ids)
        out_bytes = sum(_local(t).untyped_storage().nbytes() for t in out_tensors)
    rep = costs.report()
    live = rep["peak_live_bytes"]
    extra = {}
    if step_name == "serve_step":
        extra["caches_kept"] = _layout(out[1]) == _layout(caches)
    return {
        "step": step_name,
        "trace_s": round(time.time() - t0, 2),
        "rules": {None: "default", id(FSDP_RULES): "fsdp"}.get(
            rules if rules is None else id(rules), "custom"),
        "memory": {
            "argument_bytes": int(arg_bytes),
            "output_bytes": int(out_bytes),
            "temp_bytes": int(live - arg_bytes),
            "alias_bytes": int(alias),
            "live_bytes": int(live),
            "fits_hbm": bool(live < HW.HBM_BYTES),
        },
        "cost": {"flops": rep["flops"], "bytes_accessed": rep["bytes_accessed"]},
        "collectives": rep["collectives"],
        "ops": sum(costs.ops.values()),
        **extra,
    }


def _local(t):
    return t.to_local() if is_dtensor(t) else t


def _layout(tree):
    """Each tensor leaf's placements and local shape."""
    return [(tuple(getattr(t, "placements", ())), tuple(_local(t).shape)) for t in leaves(tree)
            if isinstance(t, torch.Tensor)]


# --------------------------------------------------------------------------- #
# one cell                                                                     #
# --------------------------------------------------------------------------- #


class fake_mesh:
    """A ``DeviceMesh`` of ``dims`` named ``axes`` on a ``"fake"`` default
    process group of their size (this process is rank 0); torn down on
    exit."""

    def __init__(self, dims: Tuple[int, ...], axes: Tuple[str, ...]):
        self.dims, self.axes = tuple(dims), tuple(axes)

    def __enter__(self):
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        from torch.testing._internal.distributed.fake_pg import FakeStore

        if dist.is_initialized():
            raise RuntimeError("the dry run needs its own (fake) default process group")
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=math.prod(self.dims))
        try:
            return init_device_mesh("cpu", self.dims, mesh_dim_names=self.axes)
        except BaseException:
            dist.destroy_process_group()
            raise

    def __exit__(self, *exc):
        import torch.distributed as dist

        dist.destroy_process_group()


def run_cell(
    arch: str,
    shape_name: str,
    mesh_kind: str,
    *,
    zero1: bool = True,
    remat: bool = True,
    verbose: bool = True,
    overrides: Optional[Dict[str, Any]] = None,
    cfg_override=None,
    mesh_shape: Optional[Tuple[Tuple[int, ...], Tuple[str, ...]]] = None,
    shape_override: Optional[ShapeConfig] = None,
) -> Dict[str, Any]:
    """One cell's record.  ``mesh_shape`` (``(shape, axis names)``) replaces
    the production mesh of ``mesh_kind`` and ``shape_override`` the shape
    (a small mesh and batch for tests; the record keeps ``shape_name``)."""
    cfg = cfg_override if cfg_override is not None else get_config(arch)
    shape = shape_override or SHAPES[shape_name]
    status = shape_cells(arch)[shape_name]
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                           "status": status}
    if status != "run":
        return rec
    dims, axes = mesh_shape or MESHES[mesh_kind]
    rec["chips"] = math.prod(dims)
    rec["mesh_shape"] = dict(zip(axes, dims))
    counts = param_counts(cfg, meta_params(cfg))
    rec.update(params_total=counts["total"], params_active=counts["active"],
               model_flops=model_flops(cfg, shape, counts), probes=PROBES)
    try:
        with fake_mesh(dims, axes) as mesh:
            rec.update(_run_step(cfg, shape, mesh, zero1=zero1, remat=remat,
                                 overrides=overrides))
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 -- recorded, the cell is marked failed
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    gc.collect()
    if verbose:
        if rec["ok"]:
            print(f"[ok] {arch:22s} {shape_name:12s} {mesh_kind:6s} trace={rec['trace_s']:6.1f}s "
                  f"flops/dev={rec['cost']['flops']:.3e} "
                  f"coll/dev={rec['collectives']['total_bytes']:.3e}B "
                  f"live={rec['memory']['live_bytes'] / 2**30:.2f}GiB", flush=True)
        else:
            print(f"[FAIL] {arch} {shape_name} {mesh_kind}: {rec.get('error')}", flush=True)
    return rec


# --------------------------------------------------------------------------- #
# command line                                                                 #
# --------------------------------------------------------------------------- #


def cell_path(out_dir: str, arch: str, shape: str, mesh: str) -> str:
    return os.path.join(out_dir, f"{arch}__{shape}__{mesh}.json")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--no-zero1", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--seqpar", action="store_true",
                    help="sequence-parallel residual stream (P(data axes, 'model', None))")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    n_ok = n_fail = n_skip = 0
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                path = cell_path(args.out, arch, shape, mesh_kind)
                if os.path.exists(path) and not args.force:
                    with open(path) as f:
                        rec = json.load(f)
                    print(f"[cached] {arch} {shape} {mesh_kind} ok={rec.get('ok')}")
                else:
                    overrides = None
                    if args.seqpar:
                        overrides = {"residual_spec": P(
                            ("pod", "data") if mesh_kind == "multi" else "data", "model", None)}
                    rec = run_cell(arch, shape, mesh_kind, zero1=not args.no_zero1,
                                   remat=not args.no_remat, overrides=overrides)
                    with open(path, "w") as f:
                        json.dump(rec, f, indent=1)
                if rec["status"] != "run":
                    n_skip += 1
                elif rec.get("ok"):
                    n_ok += 1
                else:
                    n_fail += 1
    print(f"\ndry-run matrix: ok={n_ok} fail={n_fail} skip={n_skip}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
