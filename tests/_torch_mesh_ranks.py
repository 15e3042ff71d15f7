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
  mesh; a checkpoint saved on a (4, 1) mesh and restored onto (2, 2).
* ``compress8`` (8 ranks): the compressed all-reduce on an (8,) ``data``
  mesh, each rank with its own gradient.
"""

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
        elif case == "compress8":
            _compress(out, inputs, rank)
        else:
            raise ValueError(f"unknown case {case!r}")
        np.savez(os.path.join(io_dir, f"{case}_rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
