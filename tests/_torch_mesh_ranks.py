"""One rank of the port's multi-rank CPU cases (gloo), started by
``tests/test_torch_distributed.py`` as ``python _torch_mesh_ranks.py CASE
RANK WORLD IO_DIR``.  The ranks meet through a file rendezvous in IO_DIR,
read their inputs from ``IO_DIR/inputs.npz`` (and ``IO_DIR/params``, a
checkpoint) and write their results to ``IO_DIR/<case>_rank<r>.npz``.
Imports the port only, never JAX.

Cases:

* ``mesh4`` (4 ranks): the sharded train step on a (2, 2) ``(data,
  model)`` mesh and the unsharded step; the vocab-parallel cross entropy;
  the ring matmuls on a (4,) ``model`` mesh; GPipe on a (4,) ``pipe``
  mesh; a checkpoint saved on a (4, 1) mesh and restored onto (2, 2), and
  an ADMM train state the same way.
* ``compress8`` (8 ranks): the compressed all-reduce on an (8,) ``data``
  mesh, each rank with its own gradient.
* ``admm4`` (4 ranks, ``tests/test_torch_distributed_admm.py``): the
  paper's ADMM recipe on a (2, 2) mesh and unsharded, at ``accum`` 1 and 2
  (3 ADMM steps, ``hard_prune``, one masked step); every structure's
  projection of sharded leaves under ``DEFAULT_RULES`` and ``FSDP_RULES``.
* ``zoo4`` (4 ranks, ``tests/test_torch_distributed_zoo.py``): every
  ``ARCH_IDS`` family's smoke config under both rule sets on (2, 2) and
  (4, 1) meshes against the unsharded port: one forward + backward, a
  sharded ``prefill`` (every decoder family) with each cache leaf's error
  and placements, and ``DECODE_STEPS`` decode steps from its caches
  (whisper's: placed as the dry run places a decode cell's), with every
  returned cache leaf's placements; a windowed GQA cache; the ``Engine``
  on DTensor params (``ENGINE_ARCHS`` on (2, 2), ``DEFAULT_RULES``)
  against the unsharded one; the ``RequestScheduler`` on DTensor params
  (``SCHED_CELLS`` on (2, 2)) against the unsharded one, with every cache
  leaf's placements and local rows at each tick.
* ``vocab2`` (2 ranks, ``tests/test_torch_dryrun.py``): a smoke config
  whose vocab needs no padding (256 classes) on a (1, 2) mesh, its residual
  stream cut over the batch on both axes: the logits' placements where the
  cross entropy takes them, and the loss and gradients against the
  unsharded ones.
* ``ssm4`` (4 ranks, ``tests/test_torch_distributed_ssm.py``): the Mamba-2
  and RG-LRU smoke configs (``SSM_ARCHS``) tensor-parallel over ``model``
  on (1, 4) and (2, 2) meshes under both rule sets, against the unsharded
  port: one forward + backward (with each gradient leaf's placements), a
  sharded ``prefill`` and ``DECODE_STEPS`` decode steps from its caches,
  every cache leaf kept where it lies.
"""

import dataclasses
import datetime
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

TRAIN_STEPS = 3


def _np(t):
    from repro_torch.models.sharding import is_dtensor

    t = t.full_tensor() if is_dtensor(t) else t
    return t.detach().float().numpy()


def _train(out, io_dir):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.configs import smoke_config
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import get_model
    from repro_torch.models import sharding as sh
    from repro_torch.models import transformer as tlm
    from repro_torch.training import checkpoint, optimizer, train_loop
    from repro_torch.utils.flops import meta_params
    from repro_torch.utils.tree import leaves, tree_map

    cfg = smoke_config("qwen2.5-3b")
    model = get_model(cfg)
    template = tree_map(lambda m: torch.zeros(m.shape, dtype=m.dtype), meta_params(cfg))
    ocfg = optimizer.AdamWConfig(lr=2e-3, total_steps=20, warmup_steps=2)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    for sharded in (False, True):
        params, _ = checkpoint.restore(os.path.join(io_dir, "params"), template)
        if sharded:
            specs = sh.param_pspecs(params)
            params = sh.distribute_params(mesh, params, specs=specs)
            mv = optimizer.zero1_pspecs(specs, params, data_size=2)
            state = train_loop.TrainState(
                params, optimizer.adamw_init(params, ocfg, mesh=mesh, moment_specs=mv))
        else:
            state = train_loop.init_train_state(params, ocfg)
        step = train_loop.make_train_step(model.loss, ocfg)
        pipe = SyntheticPipeline(cfg, batch=8, seq=33, seed=0)
        ces = []
        for _ in range(TRAIN_STEPS):
            b = {k: torch.from_numpy(v) for k, v in pipe.next().items()}
            if sharded:
                b = {k: distribute_tensor(v, mesh, [Shard(0), Replicate()]) for k, v in b.items()}
            state, m = step(state, b)
            ces.append(float(_np(m["ce"])))
        out[f"ce_{'sharded' if sharded else 'plain'}"] = np.asarray(ces)
    w = state.params["layers"][0]["ffn"]["w_gate"]["w"]
    mom = state.opt.m["layers"][0]["ffn"]["w_gate"]["w"]
    out["w_gate_shapes"] = np.asarray([tuple(w.shape), tuple(w.to_local().shape),
                                       tuple(mom.to_local().shape)])

    # residual_spec on the mesh: the sequence-parallel constraint, same loss
    params, _ = checkpoint.restore(os.path.join(io_dir, "params"), template)
    dp = sh.distribute_params(mesh, params)
    b = SyntheticPipeline(cfg, batch=8, seq=33, seed=0).next()
    bt = {k: distribute_tensor(torch.from_numpy(v), mesh, [Shard(0), Replicate()])
          for k, v in b.items()}
    out["loss_seqpar"] = np.asarray([
        _np(tlm.loss_fn(dp, cfg, bt)[0]),
        _np(tlm.loss_fn(dp, cfg, bt, residual_spec=sh.P("data", "model", None))[0])])

    # GQA under wider TP than KV groups: 4 query heads, 2 KV groups, a
    # 4-way model axis -- each rank's one head reads one gathered KV group
    mesh14 = make_mesh((1, 4), ("data", "model"), device="cpu")
    grads = []
    for p in (params, sh.distribute_params(mesh14, params)):
        st = train_loop.TrainState(p, None)
        bb = {k: torch.from_numpy(v) for k, v in b.items()}
        if p is not params:
            bb = {k: distribute_tensor(v, mesh14, [Shard(0), Replicate()]) for k, v in bb.items()}
        loss, _, g = train_loop._value_and_grad(model.loss, st, bb)
        grads.append((float(_np(loss)), [_np(x) for x in leaves(g)]))
    (l0, g0), (l1, g1) = grads
    out["gqa_split"] = np.asarray([l0, l1, max(np.abs(a - c).max() / max(np.abs(c).max(), 1e-30)
                                               for a, c in zip(g1, g0))])


ADMM_UPDATE_EVERY = 2


def _admm_train(out, io_dir):
    """3 ADMM steps, ``hard_prune`` and one masked step of smoke qwen2.5-3b
    at ``accum`` 1 and 2, unsharded and on a (2, 2) mesh (``DEFAULT_RULES``,
    ZeRO-1 moments): the metrics of each step, Z, U and the masks gathered,
    and whether Z, U and the masks are placed like their weights."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.configs import smoke_config
    from repro_torch.core.pruning.admm import AdmmConfig, admm_update, hard_prune
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import default_prune_plan
    from repro_torch.models import get_model
    from repro_torch.models import sharding as sh
    from repro_torch.training import checkpoint, optimizer, train_loop
    from repro_torch.utils.flops import meta_params
    from repro_torch.utils.tree import leaves, leaves_with_path, tree_map

    cfg = smoke_config("qwen2.5-3b")
    model = get_model(cfg)
    template = tree_map(lambda m: torch.zeros(m.shape, dtype=m.dtype), meta_params(cfg))
    ocfg = optimizer.AdamWConfig(lr=2e-3, total_steps=20, warmup_steps=2)
    acfg = AdmmConfig(update_every=ADMM_UPDATE_EVERY)
    plan = default_prune_plan(0.5)
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    for accum in (2, 1):
        for sharded in (False, True):
            tag = f"a{accum}_{'sharded' if sharded else 'plain'}"
            params, _ = checkpoint.restore(os.path.join(io_dir, "params"), template)
            if sharded:
                specs = sh.param_pspecs(params)
                params = sh.distribute_params(mesh, params, specs=specs)
                mv = optimizer.zero1_pspecs(specs, params, data_size=2)
                state = train_loop.init_train_state(params, ocfg, admm_cfg=acfg, prune_plan=plan)
                state.opt = optimizer.adamw_init(params, ocfg, mesh=mesh, moment_specs=mv)
            else:
                state = train_loop.init_train_state(params, ocfg, admm_cfg=acfg, prune_plan=plan)
            step = train_loop.make_train_step(model.loss, ocfg, admm_cfg=acfg, accum=accum)
            pipe = SyntheticPipeline(cfg, batch=8, seq=33, seed=0)

            def batch():
                b = {k: torch.from_numpy(v) for k, v in pipe.next().items()}
                if sharded:
                    b = {k: distribute_tensor(v, mesh, [Shard(0), Replicate()])
                         for k, v in b.items()}
                return b

            rows = []
            for _ in range(TRAIN_STEPS):
                state, m = step(state, batch())
                rows.append([float(_np(m[k])) for k in ("ce", "loss", "primal_residual")])
            out[f"{tag}_metrics"] = np.asarray(rows)
            out[f"{tag}_n_updates"] = np.asarray(state.admm.n_updates)
            adm = state.admm
            out[f"{tag}_paths"] = np.asarray([p for p, _ in leaves_with_path(adm.z)])
            for i, (z, u) in enumerate(zip(leaves(adm.z), leaves(adm.u))):
                out[f"{tag}_z{i}"], out[f"{tag}_u{i}"] = _np(z), _np(u)
            if sharded:  # the Z/U update on the mesh against the same on the whole leaves
                whole = lambda t: tree_map(lambda x: x.full_tensor(), t)  # noqa: E731
                own = lambda t: tree_map(lambda x: x.clone(), t)  # noqa: E731
                got = admm_update(state.params, dataclasses.replace(adm, u=own(adm.u)), acfg)
                ref = admm_update(whole(state.params), dataclasses.replace(
                    adm, z=whole(adm.z), u=whole(adm.u)), acfg)
                out[f"{tag}_update_exact"] = np.asarray([
                    torch.equal(a.full_tensor(), b)
                    for a, b in zip(leaves((got.z, got.u)), leaves((ref.z, ref.u)))])
            pruned, masks = hard_prune(state.params, adm)
            if sharded:
                placed = []
                for w, z, u, mk, wp in zip(*(
                        [x for x in leaves(t) if x is not None]
                        for t in (_pruned_weights(state.params, adm), adm.z, adm.u,
                                  masks, _pruned_weights(pruned, adm)))):
                    placed += [all(sh.is_dtensor(t) and t.placements == w.placements
                                   and t.to_local().shape == w.to_local().shape
                                   for t in (z, u, mk, wp))]
                out[f"{tag}_placed"] = np.asarray(placed)
                u_o = adm.u["layers"][0]["attn"]["w_o"]["w"]
                w_o = state.params["layers"][0]["attn"]["w_o"]["w"]
                out[f"{tag}_u_o"] = np.asarray([_spec(u_o), _spec(w_o)])
                out[f"{tag}_u_o_local"] = np.asarray([tuple(u_o.to_local().shape),
                                                      tuple(u_o.shape)])
            for i, mk in enumerate(leaves(masks)):
                out[f"{tag}_mask{i}"] = _np(mk)
            state = train_loop.TrainState(pruned, state.opt, None, masks)
            mstep = train_loop.make_train_step(model.loss, ocfg, accum=accum)
            state, m = mstep(state, batch())
            out[f"{tag}_masked"] = np.asarray([float(_np(m["ce"])), float(_np(m["loss"]))])


def _pruned_weights(params, adm):
    """The weights of the pruned leaves (the others ``None``), in Z's tree."""
    from repro_torch.utils.tree import map_with_path

    return map_with_path(lambda _, w, z: None if z is None else w, params, adm.z)


def _spec(t):
    """``t``'s placements as a spec string: the mesh axes of each dim."""
    names = t.device_mesh.mesh_dim_names
    dims = [[] for _ in range(t.ndim)]
    for name, p in zip(names, t.placements):
        if p.is_shard():
            dims[p.dim].append(name)
    return repr(tuple(d[0] if len(d) == 1 else (tuple(d) or None) for d in dims))


PROJ_STRUCTURES = ("unstructured", "row", "column", "channel", "block", "block_global", "nm",
                   "bank")


def _structure(name):
    from repro_torch.core.pruning import structures as st

    return {"unstructured": st.Unstructured(0.5), "row": st.Row(0.5), "column": st.Column(0.5),
            "channel": st.Channel(0.5), "block": st.Block(0.5, bm=16, bn=16),
            "block_global": st.Block(0.5, bm=16, bn=16, balanced=False),
            "nm": st.NM(n_keep=2, m=4), "bank": st.BankBalanced(0.5, bank=16)}[name]


def _projections(out, inputs):
    """Each structure's projection of the leaves of a small tree placed on a
    (2, 2) mesh by ``DEFAULT_RULES`` and by ``FSDP_RULES``: the projected
    leaf and its mask bit-equal to ``project`` on the whole leaf, placed like
    the leaf."""
    from repro_torch.core.pruning.projections import project
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import sharding as sh
    from repro_torch.utils.tree import leaves, leaves_with_path

    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    tree = {"layers": [{"attn": {"w_o": {"w": torch.from_numpy(inputs["proj_w_o"])}},
                        "ffn": {"w_gate": {"w": torch.from_numpy(inputs["proj_w_gate"])}}}],
            "embed": {"table": torch.from_numpy(inputs["proj_table"])}}
    specs = []
    for name in PROJ_STRUCTURES:
        s = _structure(name)
        ok = []
        for rules in (sh.DEFAULT_RULES, sh.FSDP_RULES):
            placed = sh.distribute_params(mesh, tree, rules)
            for (path, w), d in zip(leaves_with_path(tree), leaves(placed)):
                wp, m = project(w, s)
                dp, dm = project(d, s)
                ok.append(all(sh.is_dtensor(t) and t.placements == d.placements
                              and t.to_local().shape == d.to_local().shape for t in (dp, dm))
                          and torch.equal(dp.full_tensor(), wp)
                          and torch.equal(dm.full_tensor(), m.expand(w.shape)))
                if name == PROJ_STRUCTURES[0]:
                    specs.append(f"{path} {_spec(d)}")
        out[f"proj_{name}"] = np.asarray(ok)
    out["proj_specs"] = np.asarray(specs)


def _vocab_parallel(out, inputs):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.sharding import logsumexp_pick

    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    x = torch.from_numpy(inputs["ce_logits"])
    labels = torch.from_numpy(inputs["ce_labels"])
    xd = distribute_tensor(x.clone(), mesh, [Shard(0), Shard(2)]).requires_grad_()
    ld = distribute_tensor(labels, mesh, [Shard(0), Replicate()])
    lse, picked = logsumexp_pick(xd, ld)
    (lse - picked).sum().backward()
    out["ce_lse"], out["ce_picked"], out["ce_grad"] = _np(lse), _np(picked), _np(xd.grad)


def _ring(out, inputs):
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training.collective_matmul import make_overlapped_tp_matmuls

    mesh = make_mesh((4,), ("model",), device="cpu")
    ag, rs = make_overlapped_tp_matmuls(mesh)
    for name, fn in (("ag", ag), ("rs", rs)):
        x = distribute_tensor(torch.from_numpy(inputs["ring_x"]), mesh, [Replicate()])
        w = distribute_tensor(torch.from_numpy(inputs["ring_w"]), mesh, [Replicate()])
        x.requires_grad_()
        w.requires_grad_()
        y = fn(x, w)
        (y.full_tensor() ** 2).sum().backward()
        out[f"{name}_y"], out[f"{name}_dx"], out[f"{name}_dw"] = _np(y), _np(x.grad), _np(w.grad)


def _gpipe(out, inputs):
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training.pipeline_parallel import make_pipelined_loss, pipeline_forward

    mesh = make_mesh((4,), ("pipe",), device="cpu")
    w = torch.from_numpy(inputs["pipe_w"]).requires_grad_()
    x, y = torch.from_numpy(inputs["pipe_x"]), torch.from_numpy(inputs["pipe_y"])

    def layer(lp, h):
        return torch.tanh(h @ lp["w"])

    with torch.no_grad():
        out["pipe_out"] = pipeline_forward(layer, {"w": w}, x, mesh=mesh).numpy()
        ref = x
        for i in range(w.shape[0]):
            ref = layer({"w": w[i]}, ref)
        out["pipe_seq"] = ref.numpy()
    loss = make_pipelined_loss(layer, lambda o, t: torch.mean((o - t) ** 2), mesh=mesh)
    loss({"w": w}, x, y).backward()
    g = w.grad.clone()
    dist.all_reduce(g)  # each stage holds its rows' share
    out["pipe_grad"] = g.numpy()


def _elastic(out, io_dir):
    from repro_torch.configs import smoke_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import get_model
    from repro_torch.models import sharding as sh
    from repro_torch.training import checkpoint
    from repro_torch.utils.tree import leaves, leaves_with_path

    cfg = smoke_config("granite-3-2b")
    params = get_model(cfg).init(torch.Generator().manual_seed(0))
    mesh_a = make_mesh((4, 1), ("data", "model"), device="cpu")
    params_a = sh.distribute_params(mesh_a, params)
    ckpt = os.path.join(io_dir, "elastic")
    checkpoint.save(ckpt, 7, params_a)
    mesh_b = make_mesh((2, 2), ("data", "model"), device="cpu")
    restored, at = checkpoint.restore(ckpt, params, placements=sh.param_shardings(mesh_b, params))
    same = [bool(torch.equal(r.full_tensor(), p)) for r, p in zip(leaves(restored), leaves(params))]
    w = restored["layers"][0]["ffn"]["w_gate"]["w"]
    out["elastic"] = np.asarray([at, all(same), len(same), w.device_mesh.size(1),
                                 w.to_local().shape[1], w.shape[1]])
    out["elastic_paths"] = np.asarray([p for p, _ in leaves_with_path(restored)])


def _elastic_admm(out, io_dir):
    """An ADMM ``TrainState`` of smoke qwen2.5-3b (params, ZeRO-1 moments, Z
    and U with their ``None`` leaves) after one step on a (4, 1) mesh, saved
    and restored onto (2, 2) with Z / U placed like the params: bit-exact,
    and its next step equal to the next step of the same state moved onto
    (2, 2) without the save, and within 1e-5 of the next step on (4, 1)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.configs import smoke_config
    from repro_torch.core.pruning.admm import AdmmConfig
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import default_prune_plan
    from repro_torch.models import get_model
    from repro_torch.models import sharding as sh
    from repro_torch.training import checkpoint, optimizer, train_loop
    from repro_torch.utils.flops import meta_params
    from repro_torch.utils.tree import leaves, map_with_path, tree_map

    cfg = smoke_config("qwen2.5-3b")
    model = get_model(cfg)
    template = tree_map(lambda m: torch.zeros(m.shape, dtype=m.dtype), meta_params(cfg))
    params, _ = checkpoint.restore(os.path.join(io_dir, "params"), template)
    ocfg = optimizer.AdamWConfig(lr=2e-3, total_steps=20, warmup_steps=2)
    acfg = AdmmConfig(update_every=1)
    step = train_loop.make_train_step(model.loss, ocfg, admm_cfg=acfg)
    pipe = SyntheticPipeline(cfg, batch=8, seq=17, seed=0)
    batches = [{k: torch.from_numpy(v) for k, v in pipe.next().items()} for _ in range(2)]
    specs = sh.param_pspecs(params)

    def on(mesh, b):
        return {k: distribute_tensor(v, mesh, [Shard(0), Replicate()]) for k, v in b.items()}

    def shardings(mesh, state):
        """The state's placements on ``mesh``: params by the rules, moments
        ZeRO-1, Z / U like the params."""
        ns = lambda t: tree_map(lambda s: sh.NamedSharding(mesh, s), t)  # noqa: E731
        rep = sh.NamedSharding(mesh, sh.P())
        mv = optimizer.zero1_pspecs(specs, params, data_size=mesh.size(0))
        zs = map_with_path(lambda _, s, z: None if z is None else s, specs, state.admm.z)
        return train_loop.TrainState(
            ns(specs), optimizer.AdamWState(rep, ns(mv), ns(mv)),
            dataclasses.replace(state.admm, z=ns(zs), u=ns(zs), rho=rep, n_updates=rep))

    mesh_a = make_mesh((4, 1), ("data", "model"), device="cpu")
    mesh_b = make_mesh((2, 2), ("data", "model"), device="cpu")
    pa = sh.distribute_params(mesh_a, params, specs=specs)
    state = train_loop.init_train_state(pa, ocfg, admm_cfg=acfg, prune_plan=default_prune_plan(0.5))
    state.opt = optimizer.adamw_init(pa, ocfg, mesh=mesh_a, moment_specs=optimizer.zero1_pspecs(
        specs, pa, data_size=4))
    state, _ = step(state, on(mesh_a, batches[0]))
    ckpt = os.path.join(io_dir, "elastic_admm")
    checkpoint.save(ckpt, 1, state)
    place_b = shardings(mesh_b, state)
    restored, at = checkpoint.restore(ckpt, state, placements=place_b)

    def whole(x):
        return x.full_tensor() if sh.is_dtensor(x) else x

    def same(a, b):
        return all(torch.equal(whole(x), whole(y)) if isinstance(x, torch.Tensor) else x == y
                   for x, y in zip(leaves(a), leaves(b)))

    # the step updates its state in place: the moved copy must own its tensors
    moved = tree_map(lambda x, ns: distribute_tensor(x.full_tensor().clone(), ns.mesh,
                                                     ns.placements)
                     if sh.is_dtensor(x) else x, state, place_b)
    u = restored.admm.u["layers"][0]["attn"]["w_o"]["w"]
    w = restored.params["layers"][0]["attn"]["w_o"]["w"]
    placed = (u.placements == w.placements and u.device_mesh.shape == (2, 2)
              and u.to_local().shape == w.to_local().shape)
    exact = same(restored, state)
    n_none = len(leaves(params)) - len(leaves(state.admm.z))  # the dense leaves
    after_b, m_b = step(restored, on(mesh_b, batches[1]))
    moved_b, mm_b = step(moved, on(mesh_b, batches[1]))
    after_a, m_a = step(state, on(mesh_a, batches[1]))
    losses = [float(_np(m["loss"])) for m in (m_b, mm_b, m_a)]
    out["elastic_admm"] = np.asarray([at, exact, placed, n_none > 0, restored.admm.n_updates,
                                      same(after_b, moved_b), same(m_b, mm_b)])
    out["elastic_admm_losses"] = np.asarray(losses)
    out["elastic_admm_residual"] = np.asarray([float(_np(m["primal_residual"]))
                                               for m in (m_b, m_a)])


def _compress(out, inputs, rank):
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training.compression import CompressionConfig, make_compressed_allreduce

    mesh = make_mesh((8,), ("data",), device="cpu")
    g = {"w": torch.from_numpy(inputs["comp_g"][rank])}
    zero = {"w": torch.zeros(16, 32)}
    f = make_compressed_allreduce(mesh, zero, cfg=CompressionConfig("int8"))
    mean, err = f(g, zero)
    mean2, _ = f(g, err)
    out["int8_mean"], out["int8_err"], out["int8_mean2"] = (
        mean["w"].numpy(), err["w"].numpy(), mean2["w"].numpy())
    for policy, kw in (("topk", dict(topk_frac=0.5)), ("none", {})):
        f = make_compressed_allreduce(mesh, zero, cfg=CompressionConfig(policy, **kw))
        mean, err = f(g, zero)
        out[f"{policy}_mean"], out[f"{policy}_err"] = mean["w"].numpy(), err["w"].numpy()


ZOO_MESHES = ((2, 2), (4, 1))
ZOO_RULES = ("default", "fsdp")
#: the train batch; the decode batch, cache slots and the prefix filled
#: before the decode steps (their slots 19-21 cross the (2, 2) mesh's cut
#: of the 40 slots at 20)
ZOO_BATCH, ZOO_SEQ = 4, 16
ZOO_MAX_LEN, ZOO_FILL, DECODE_STEPS = 40, 19, 3
#: the windowed GQA cache: a ring of 8 slots, 4 a rank on (2, 2)
ZOO_WINDOW = 8


def zoo_decode_inputs(cfg, seed=0):
    """The decode run's numpy inputs for ``cfg`` (either package's config):
    the prompt's text tokens (the VLM's 16 patches fill the rest of the
    ``ZOO_FILL`` positions), its patch embeddings or whisper's frames, and
    the ``DECODE_STEPS`` tokens fed one a step."""
    rng = np.random.default_rng(seed)
    b, d = ZOO_BATCH, cfg.d_model
    out = {"prompt": rng.integers(0, cfg.vocab, (b, ZOO_FILL - (cfg.vision_tokens or 0))
                                  ).astype(np.int32),
           "steps": rng.integers(0, cfg.vocab, (b, DECODE_STEPS)).astype(np.int32)}
    if cfg.vision_tokens:
        out["patch_embeds"] = rng.standard_normal((b, cfg.vision_tokens, d)).astype(np.float32)
    if cfg.is_encdec:
        out["frames"] = rng.standard_normal((b, cfg.encoder_seq, d)).astype(np.float32)
    return out


def _zoo_fill(model, params, inp, max_len, mesh=None):
    """``(logits, caches)`` after the prompt: ``prefill`` -- on ``mesh``
    with the prompt and patch embeddings cut over the batch, ``params``
    then DTensors -- or for whisper (no logits) its encoder, the cross K/V
    and one decode step a prompt token."""
    from repro_torch.models import encdec
    from repro_torch.models import sharding as sh
    from repro_torch.models import transformer as tlm

    cfg = model.cfg
    prompt = torch.from_numpy(inp["prompt"])
    if cfg.is_encdec:
        enc = encdec.encode(params, cfg, torch.from_numpy(inp["frames"]))
        caches = (model.init_cache(prompt.shape[0], max_len),
                  encdec.precompute_cross_kv(params, cfg, enc))
        for t in range(prompt.shape[1]):
            _, caches = model.decode_step(params, {"tokens_t": prompt[:, t:t + 1]}, caches)
        return None, caches
    pe = inp.get("patch_embeds")
    pe = None if pe is None else torch.from_numpy(pe)
    if mesh is not None:
        prompt = sh.place_rows(prompt, mesh)
        pe = None if pe is None else sh.place_rows(pe, mesh)
    return tlm.prefill(params, cfg, prompt, max_len, patch_embeds=pe)


def _prefill_check(out, tag, logits, caches, ref_logits, ref_caches, mesh):
    """The sharded prefill against the plain one: the logits' error and
    each cache leaf's (relative to its max |plain|; an int leaf, ``pos``:
    0 where equal, inf where not), and whether each leaf lies where
    ``place_caches`` puts the plain one (placements and local shape)."""
    from repro_torch.utils.tree import leaves

    got = _np(logits)
    out[f"{tag}_prefill_logits"] = got
    out[f"{tag}_prefill_err"] = np.asarray(np.abs(got - ref_logits).max()
                                           / np.abs(ref_logits).max())
    errs = []
    for c, r in zip(leaves(caches), leaves(ref_caches)):
        a, b = _np(c), _np(r)
        if r.is_floating_point():
            errs.append(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
        else:
            errs.append(0.0 if np.array_equal(a, b) else np.inf)
    out[f"{tag}_prefill_cache_err"] = np.asarray(errs)
    out[f"{tag}_prefill_placed"] = np.asarray([
        g == w for g, w in zip(_layout(caches), _layout(place_caches(ref_caches, mesh)))])


def _place(tree, specs, mesh):
    """``tree`` -- the same on every rank -- placed by ``specs``, each rank
    keeping its chunk (no collective)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.models import sharding as sh
    from repro_torch.utils.tree import map_with_path

    return map_with_path(lambda _, t, s: distribute_tensor(
        t, mesh, sh.param_placements(mesh, s), src_data_rank=None), tree, specs)


def place_caches(caches, mesh):
    """``caches`` placed on ``mesh`` as the dry run places a decode cell's
    (``sharding.cache_pspecs``, the JAX package's ``_cache_pspecs``: batch
    over ``data``, sequence, heads or channels over ``model``)."""
    from repro_torch.models import sharding as sh

    return _place(caches, sh.cache_pspecs(caches, mesh), mesh)


def _layout(tree):
    """Each leaf's placements and local shape."""
    from repro_torch.utils.tree import leaves

    return [(tuple(t.placements), tuple(t.to_local().shape)) for t in leaves(tree)]


def _zoo_decode(model, params, caches, steps, mesh=None):
    """``DECODE_STEPS`` decode steps: the logits of each, and on a mesh
    whether every cache leaf came back in the placements and local shape it
    was given."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.models import sharding as sh

    given = _layout(caches) if mesh is not None else None
    logits, kept = [], []
    for t in range(steps.shape[1]):
        tok = torch.from_numpy(steps[:, t:t + 1])
        if mesh is not None:
            tok = distribute_tensor(tok, mesh, sh.param_placements(mesh, sh.batch_spec(mesh)))
        with sh.mesh_context(params, tok, caches):
            lg, caches = model.decode_step(params, {"tokens_t": tok}, caches)
        logits.append(_np(lg))
        if mesh is not None:
            kept.append(_layout(caches) == given)
    return np.stack(logits), np.asarray(kept)


def _grad_err(grads, plain, mesh):
    """max |sharded - plain| of each gradient leaf over the mesh: each rank
    compares its shard with its chunk of the plain gradient, and one
    all-reduce takes the max."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.models.sharding import reduce_partial
    from repro_torch.utils.tree import leaves

    def err(g, p):
        g = reduce_partial(g)
        mine = distribute_tensor(torch.from_numpy(p), mesh, g.placements, src_data_rank=None)
        d = g.to_local() - mine.to_local()
        return d.abs().max() if d.numel() else torch.zeros(())

    errs = torch.stack([err(g, p) for g, p in zip(leaves(grads), plain)])
    dist.all_reduce(errs, op=dist.ReduceOp.MAX)
    return errs.numpy()


def _zoo_batch(cfg):
    from repro_torch.data.pipeline import SyntheticPipeline

    return SyntheticPipeline(cfg, batch=ZOO_BATCH, seq=ZOO_SEQ + 1, seed=0).next()


def _zoo(out, io_dir):
    """Every family's sharded forward + backward and decode steps against the
    unsharded port's (``zoo4``)."""
    from repro_torch.configs import ARCH_IDS
    from repro_torch.launch.mesh import make_mesh

    meshes = {shape: make_mesh(shape, ("data", "model"), device="cpu") for shape in ZOO_MESHES}
    _families(out, io_dir, ARCH_IDS, meshes, lambda arch, shape, name: (
        arch.startswith("deepseek") and name == "fsdp" and shape == (2, 2)),
        lambda arch, shape, name: arch in ENGINE_ARCHS and shape == (2, 2) and name == "default",
        lambda arch, shape, name: (arch, name) in SCHED_CELLS and shape == (2, 2))
    _zoo_window(out, meshes[(2, 2)])


def _families(out, io_dir, archs, meshes, keep_grads, engine=lambda *cell: False,
              scheduler=lambda *cell: False):
    """Each of ``archs``' smoke config, unsharded and on each of ``meshes``
    under both rule sets: the loss, each gradient leaf's error (and, where
    ``keep_grads(arch, shape, rules)``, the leaves), whether each came back
    in its weight's placements and local shape, the sharded prefill against
    the plain one (``_prefill_check``), and ``DECODE_STEPS`` decode steps'
    logits from its caches with whether the caches and weights kept theirs;
    where ``engine(arch, shape, rules)``, the ``Engine`` on the sharded
    params against the plain one (``_engine``); where ``scheduler(arch,
    shape, rules)``, the ``RequestScheduler`` likewise (``_scheduler``)."""
    import time

    from repro_torch.configs import smoke_config
    from repro_torch.models import get_model
    from repro_torch.models import sharding as sh
    from repro_torch.training import checkpoint, train_loop
    from repro_torch.utils.flops import meta_params
    from repro_torch.utils.tree import leaves, leaves_with_path, tree_map

    rules = {"default": sh.DEFAULT_RULES, "fsdp": sh.FSDP_RULES}
    for arch in archs:
        t0 = time.perf_counter()
        cfg = smoke_config(arch)
        model = get_model(cfg, device="cpu")
        template = tree_map(lambda m: torch.zeros(m.shape, dtype=m.dtype), meta_params(cfg))
        params, _ = checkpoint.restore(os.path.join(io_dir, f"params_{arch}"), template)
        batch = {k: torch.from_numpy(v) for k, v in _zoo_batch(cfg).items()}
        loss, _, grads = train_loop._value_and_grad(model.loss, train_loop.TrainState(
            params, None), batch)
        out[f"{arch}_loss"] = np.asarray(float(loss))
        g_plain = [_np(g) for g in leaves(grads)]
        out[f"{arch}_grad_max"] = np.asarray([np.abs(g).max() for g in g_plain])
        inp = zoo_decode_inputs(cfg)
        fill_logits, caches = _zoo_fill(model, params, inp, ZOO_MAX_LEN)
        out[f"{arch}_logits"], _ = _zoo_decode(model, params, caches, inp["steps"])
        for shape, mesh in meshes.items():
            bd = _place(batch, {k: sh.P("data") for k in batch}, mesh)
            for name, r in rules.items():
                tag = f"{arch}_{shape[0]}x{shape[1]}_{name}"
                dp = _place(params, sh.param_pspecs(params, r), mesh)
                weights = _layout(dp)
                loss, _, grads = train_loop._value_and_grad(
                    model.loss, train_loop.TrainState(dp, None), bd)
                out[f"{tag}_loss"] = np.asarray(float(_np(loss)))
                out[f"{tag}_grad_err"] = _grad_err(grads, g_plain, mesh)
                out[f"{tag}_grad_cut"] = np.asarray([g == w for g, w in zip(
                    _layout(tree_map(sh.reduce_partial, grads)), weights)])
                if keep_grads(arch, shape, name):
                    for i, x in enumerate(leaves(grads)):
                        out[f"{tag}_grad{i}"] = _np(x)
                if cfg.is_encdec:  # no prefill: the plain caches, placed
                    start = place_caches(caches, mesh)
                else:
                    lg, start = _zoo_fill(model, dp, inp, ZOO_MAX_LEN, mesh)
                    _prefill_check(out, tag, lg, start, _np(fill_logits), caches, mesh)
                out[f"{tag}_logits"], out[f"{tag}_kept"] = _zoo_decode(
                    model, dp, start, inp["steps"], mesh)
                if engine(arch, shape, name):
                    _engine(out, arch, model, params, dp, inp, mesh)
                if scheduler(arch, shape, name):
                    _scheduler(out, arch, name, model, params, dp, mesh)
                out[f"{tag}_weights_kept"] = np.asarray(_layout(dp) == weights)
        out[f"{arch}_paths"] = np.asarray([p for p, _ in leaves_with_path(params)])
        print(f"{arch}: {time.perf_counter() - t0:.1f}s", flush=True)


#: the ``Engine`` on the mesh: these families on (2, 2) under
#: ``DEFAULT_RULES``, ``ENGINE_STEPS`` new tokens a row
ENGINE_ARCHS = ("qwen2.5-3b", "mamba2-1.3b", "paligemma-3b")
ENGINE_STEPS = 4


def _in_place(caches, mesh) -> bool:
    """Whether every cache leaf has its ``sharding.cache_pspecs`` placements."""
    from repro_torch.models import sharding as sh
    from repro_torch.utils.tree import leaves

    specs = leaves(sh.cache_pspecs(caches, mesh))
    return [tuple(t.placements) for t in leaves(caches)] == [
        tuple(sh.param_placements(mesh, s)) for s in specs]


def _engine(out, arch, model, params, dp, inp, mesh):
    """``Engine.generate`` on the plain params and on their DTensors ``dp``:
    both runs' greedy tokens, the plain run's logits at each step (the
    near-tie rule reads them) and, after each sharded decode step, whether
    every cache leaf came back in the placements and local shape it went in
    with, those of ``cache_pspecs``."""
    from repro_torch.serving.engine import Engine

    tokens = []
    for p in (params, dp):
        eng = Engine(model, p, batch_size=ZOO_BATCH, max_len=ZOO_MAX_LEN)
        sample, decode, logits, kept = eng._sample, eng._decode, [], []

        def recorded(lg, sample=sample, logits=logits):
            logits.append(lg.float().numpy())
            return sample(lg)

        def checked(params, tok, caches, decode=decode, kept=kept):
            lg, new = decode(params, tok, caches)
            kept.append(_layout(new) == _layout(caches) and _in_place(caches, mesh))
            return lg, new

        eng._sample = recorded
        if p is dp:
            eng._decode = checked
        tokens.append(eng.generate(inp["prompt"], ENGINE_STEPS,
                                   patch_embeds=inp.get("patch_embeds")).tokens)
        if p is params:
            out[f"{arch}_engine_logits"] = np.stack(logits)
    out[f"{arch}_engine_tokens"] = np.stack(tokens)
    out[f"{arch}_engine_kept"] = np.asarray(kept)


#: the ``RequestScheduler`` on the mesh: (arch, rules) cells on (2, 2);
#: ``SCHED_REQUESTS`` requests over ``ZOO_BATCH`` slots of ``ZOO_MAX_LEN``
SCHED_ARCHS = ("qwen2.5-3b", "deepseek-v2-lite-16b", "mamba2-1.3b", "recurrentgemma-9b")
SCHED_CELLS = tuple((a, "default") for a in SCHED_ARCHS) + (("deepseek-v2-lite-16b", "fsdp"),)
SCHED_REQUESTS, SCHED_MAX_NEW = 7, 4


def zoo_sched_requests(cfg, seed=0):
    """The scheduler run's requests for ``cfg`` (either package's config):
    ``SCHED_REQUESTS`` pairs ``(prompt, max_new)``, prompts of 5 or 9
    tokens, 2-``SCHED_MAX_NEW`` new tokens each: more requests than slots,
    so slots are refilled while the others decode."""
    rng = np.random.default_rng(seed)
    lens = rng.choice([5, 9], SCHED_REQUESTS)
    news = rng.integers(2, SCHED_MAX_NEW + 1, SCHED_REQUESTS)
    return [(rng.integers(0, cfg.vocab, int(n)).astype(np.int32), int(m))
            for n, m in zip(lens, news)]


def _scheduler(out, arch, rules, model, params, dp, mesh):
    """``RequestScheduler`` over an ``Engine`` of ``ZOO_BATCH`` slots on the
    plain params (once an arch) and on their DTensors ``dp``: each request's
    greedy tokens (``[SCHED_REQUESTS, SCHED_MAX_NEW]``, -1 past its
    ``max_new``), the plain run's logits behind each token (the near-tie
    rule reads them) and, at each sharded tick, whether every cache leaf --
    as spliced and as the decode step returns it -- has its ``cache_pspecs``
    placements and ``ZOO_BATCH / 2`` local rows."""
    import time

    from repro_torch.serving.engine import Engine, Request, RequestScheduler
    from repro_torch.utils.tree import leaves

    def cut(caches):
        return all(t.to_local().shape[0] == ZOO_BATCH // 2 for t in leaves(caches))

    t0 = time.perf_counter()
    for p in ((params, dp) if f"{arch}_sched_tokens" not in out else (dp,)):
        eng = Engine(model, p, batch_size=ZOO_BATCH, max_len=ZOO_MAX_LEN)
        sched = RequestScheduler(eng)
        reqs = [Request(j, prompt, n) for j, (prompt, n) in
                enumerate(zoo_sched_requests(model.cfg))]
        prefill, decode, logits, placed, rows = eng._prefill, eng._decode, [], [], []
        admitted = iter(reqs)

        def prefilled(pp, tok, pe=None, prefill=prefill, logits=logits, admitted=admitted):
            lg, caches = prefill(pp, tok, pe)
            logits.append((next(admitted).rid, lg[0].float().numpy()))
            return lg, caches

        def decoded(pp, tok, caches, decode=decode, logits=logits, sched=sched):
            lg, new = decode(pp, tok, caches)
            logits.extend((s.rid, lg[i].float().numpy()) for i, s in enumerate(sched.slots)
                          if s is not None and not s.done)
            if p is dp:
                placed.append(_in_place(caches, mesh) and _in_place(new, mesh))
                rows.append(cut(caches) and cut(new))
            return lg, new

        eng._prefill, eng._decode = prefilled, decoded
        for r in reqs:
            sched.submit(r)
        sched.run()
        tokens = np.full((SCHED_REQUESTS, SCHED_MAX_NEW), -1, np.int32)
        for r in reqs:
            tokens[r.rid, :len(r.generated)] = r.generated
        if p is params:
            out[f"{arch}_sched_tokens"] = tokens
            v = logits[0][1].shape[-1]
            lg = np.zeros((SCHED_REQUESTS, SCHED_MAX_NEW, v), np.float32)
            for j in range(SCHED_REQUESTS):
                mine = [x for rid, x in logits if rid == j]
                lg[j, :len(mine)] = mine
            out[f"{arch}_sched_logits"] = lg
        else:
            out[f"{arch}_{rules}_sched_tokens"] = tokens
            out[f"{arch}_{rules}_sched_placed"] = np.asarray(placed)
            out[f"{arch}_{rules}_sched_rows"] = np.asarray(rows)
            out[f"{arch}_{rules}_sched_done"] = np.asarray(
                [r.done and len(r.generated) == r.max_new for r in reqs])
    print(f"{arch} scheduler ({rules}): {time.perf_counter() - t0:.1f}s", flush=True)


def _zoo_window(out, mesh):
    """A windowed GQA layer's decode steps on a ring cache of ``ZOO_WINDOW``
    slots, cut over ``model``, against the plain steps."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import attention as attn
    from repro_torch.models import sharding as sh

    cfg = smoke_config("qwen2.5-3b")
    gen = torch.Generator().manual_seed(1)
    p = attn.init_gqa(gen, cfg, torch.float32)
    x = torch.randn(ZOO_BATCH, ZOO_FILL + DECODE_STEPS, cfg.d_model, generator=gen)
    pos = torch.arange(ZOO_FILL).expand(ZOO_BATCH, ZOO_FILL)
    _, cache = attn.gqa_prefill(p, cfg, x[:, :ZOO_FILL], pos, ZOO_MAX_LEN, window=ZOO_WINDOW)
    dp = sh.distribute_params(mesh, {"attn": p})["attn"]
    dc = place_caches(cache, mesh)
    given = _layout(dc)
    ys, kept = [], []
    for t in range(DECODE_STEPS):
        xt = x[:, ZOO_FILL + t:ZOO_FILL + t + 1]
        y, cache = attn.gqa_decode_step(p, cfg, xt, cache, window=ZOO_WINDOW)
        xd = _place(xt, sh.P("data", None, None), mesh)
        with sh.mesh_context(dp, xd, dc):
            yd, dc = attn.gqa_decode_step(dp, cfg, xd, dc, window=ZOO_WINDOW)
        ys.append((_np(y), _np(yd)))
        kept.append(_layout(dc) == given)
    out["window_y"] = np.asarray(ys)
    out["window_kept"] = np.asarray(kept)
    out["window_cut"] = np.asarray([repr(pl) for pl, _ in given])


SSM_ARCHS = ("mamba2-1.3b", "recurrentgemma-9b")
SSM_MESHES = ((1, 4), (2, 2))


def _ssm(out, io_dir):
    """The recurrent mixers' sharded forward + backward and decode steps
    against the unsharded port's (``ssm4``); on (1, 4) the gradients are
    kept, for the JAX package's sharded step."""
    from repro_torch.launch.mesh import make_mesh

    meshes = {shape: make_mesh(shape, ("data", "model"), device="cpu") for shape in SSM_MESHES}
    _families(out, io_dir, SSM_ARCHS, meshes, lambda arch, shape, name: shape == (1, 4))


def _vocab2(out):
    """``vocab2``: qwen2.5-3b's smoke config (vocab 256 == its padded vocab)
    in f32 on a (1, 2) ``(data, model)`` mesh, with ``residual_spec`` cutting
    the residual stream's batch over both axes, so the head's input arrives
    split over ``model``: the placements of the logits ``loss_fn`` hands
    the cross entropy, and the loss and every gradient leaf's error against
    the unsharded step's."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.data.pipeline import SyntheticPipeline
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import sharding as sh
    from repro_torch.models import transformer as tlm
    from repro_torch.training import train_loop
    from repro_torch.utils.tree import leaves

    cfg = dataclasses.replace(smoke_config("qwen2.5-3b"), dtype="float32")
    assert cfg.vocab == cfg.vocab_padded == 256
    mesh = make_mesh((1, 2), ("data", "model"), device="cpu")
    params = tlm.init_lm(torch.Generator().manual_seed(0), cfg)
    batch = {k: torch.from_numpy(v) for k, v in
             SyntheticPipeline(cfg, batch=8, seq=129, seed=0).next().items()}
    seen, pick = [], tlm.logsumexp_pick

    def recorded(x, labels):
        if sh.is_dtensor(x):
            seen.append(repr(tuple(x.placements)))
        return pick(x, labels)

    tlm.logsumexp_pick = recorded
    spec = sh.P(("data", "model"), None, None)
    losses, grads = [], []
    for p, b in ((params, batch), (sh.distribute_params(mesh, params),
                                   {k: sh.place_rows(v, mesh) for k, v in batch.items()})):
        loss, _, g = train_loop._value_and_grad(
            lambda pp, bb: tlm.loss_fn(pp, cfg, bb, residual_spec=spec),
            train_loop.TrainState(p, None), b)
        losses.append(float(_np(loss)))
        grads.append([_np(x) for x in leaves(g)])
    out["vocab2_placements"] = np.asarray(seen)
    out["vocab2_loss"] = np.asarray(losses)
    out["vocab2_grad_err"] = np.asarray([np.abs(a - c).max() / max(np.abs(c).max(), 1e-30)
                                         for a, c in zip(grads[1], grads[0])])


def main(case: str, rank: int, world: int, io_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(io_dir, 'rdzv_' + case)}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=90))
    try:
        inputs = dict(np.load(os.path.join(io_dir, "inputs.npz")))
        out = {}
        if case == "mesh4":
            _train(out, io_dir)
            _vocab_parallel(out, inputs)
            _ring(out, inputs)
            _gpipe(out, inputs)
            _elastic(out, io_dir)
            _elastic_admm(out, io_dir)
        elif case == "compress8":
            _compress(out, inputs, rank)
        elif case == "admm4":
            _projections(out, inputs)
            _admm_train(out, io_dir)
        elif case == "zoo4":
            _zoo(out, io_dir)
        elif case == "ssm4":
            _ssm(out, io_dir)
        elif case == "vocab2":
            _vocab2(out)
        else:
            raise ValueError(f"unknown case {case!r}")
        np.savez(os.path.join(io_dir, f"{case}_rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
