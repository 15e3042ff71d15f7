"""Graph transformation passes (paper section 3, "DSL related optimization"
plus the sparse-execution planning that consumes pruning masks).

A port of ``repro.core.graph.passes``: the same rewrites in the same order,
on graphs whose params are torch tensors, so an app's optimized graph has
the same nodes, attrs and param shapes as the reference's.

Pass pipeline for deployment (see :func:`optimize`):

1. ``fold_norm``         Conv/Linear + BatchNorm -> folded Conv/Linear
2. ``fuse_activation``   Conv/Linear + Activation -> fused epilogue attr
3. ``substitute_sparse`` pruned weights -> compact formats + sparse ops
                         (ColumnCompact / ChannelCompact / PBCSR+reorder)
4. ``fold_gathers``      compaction gathers folded into adjacent weights
5. ``cse`` / ``fuse_elementwise`` / ``fuse_epilogue``
6. ``quantize``          GEMM/conv weights -> INT8 ``qlinear`` / ``qconv2d``
                         (skipped without a calibration table)
7. ``dce``               drop dead nodes

All passes are pure: Graph in, Graph out.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...quant.qtensor import QTensor
from ..pruning.structures import Block, Channel, Column, Structure
from ..sparse.formats import PBCSR, ChannelCompact, ColumnCompact
from ..sparse.packing import block_mask
from ..sparse.reorder import apply_column_perm, plan_reorder
from .ir import Graph, Node

__all__ = [
    "fold_norm",
    "fuse_activation",
    "substitute_sparse",
    "fold_gathers",
    "fuse_elementwise",
    "fuse_epilogue",
    "quantize",
    "cse",
    "dce",
    "optimize",
]

_FUSABLE = ("linear", "conv2d", "sparse_linear")


# --------------------------------------------------------------------------- #
# 1. norm folding                                                              #
# --------------------------------------------------------------------------- #


def fold_norm(g: Graph) -> Graph:
    """Fold BatchNorm (inference stats) into the preceding conv/linear.

    y = scale * (conv(x) - mean) / sqrt(var + eps) + bias
      = conv'(x) + b'   with w' = w * s, b' = (b - mean) * s + bias,
      s = scale / sqrt(var + eps).

    Instance/Layer norm have data-dependent statistics and are left alone
    (the paper folds BN only).
    """
    g = dataclasses.replace(g, nodes=list(g.nodes), params=dict(g.params))
    for node in list(g.nodes):
        if node.op != "norm" or node.attrs.get("kind") != "batch":
            continue
        (src_name,) = node.inputs
        try:
            src = g.node(src_name)
        except KeyError:
            continue
        if src.op not in ("linear", "conv2d"):
            continue
        if len(g.consumers(src_name)) != 1:
            continue  # conv output used elsewhere: cannot fold
        p = g.params[node.name]
        eps = node.attrs.get("eps", 1e-5)
        s = p["scale"] / torch.sqrt(p["var"] + eps)
        sp = dict(g.params[src_name])
        w = sp["w"]
        if src.op == "conv2d":  # w [Co, Ci, kh, kw]; stats per Co
            sp["w"] = w * s[:, None, None, None]
        else:  # linear w [K, N]; stats per N
            sp["w"] = w * s[None, :]
        b = sp.get("b")
        b = torch.zeros(s.shape, dtype=w.dtype, device=w.device) if b is None else b
        sp["b"] = (b - p["mean"]) * s + p["bias"]
        g.params[src_name] = sp
        g = g.without({node.name}).rewire(node.name, src_name)
    g.validate()
    return g


# --------------------------------------------------------------------------- #
# 2. activation fusion                                                         #
# --------------------------------------------------------------------------- #


def fuse_activation(g: Graph) -> Graph:
    """Attach a following activation node to its GEMM producer as a fused
    epilogue attr (executed inside the kernel)."""
    for node in list(g.nodes):
        if node.op != "activation":
            continue
        (src_name,) = node.inputs
        try:
            src = g.node(src_name)
        except KeyError:
            continue
        if src.op not in _FUSABLE or src.attrs.get("activation"):
            continue
        if len(g.consumers(src_name)) != 1:
            continue
        new_src = src.replace(attrs={**src.attrs, "activation": node.attrs["fn"]})
        g = g.replace_node(src_name, new_src)
        g = g.without({node.name}).rewire(node.name, src_name)
    g.validate()
    return g


# --------------------------------------------------------------------------- #
# 3. sparse substitution                                                       #
# --------------------------------------------------------------------------- #


def substitute_sparse(
    g: Graph,
    masks: Dict[str, Any],
    structures: Dict[str, Structure],
    *,
    max_bands: int = 4,
) -> Graph:
    """Rewrite pruned linear/conv nodes to their compact execution form.

    ``masks``/``structures`` are keyed by node name.  Rules:

    * Column  -> ``sparse_linear(format=colcompact)``: gather + smaller GEMM.
    * Channel -> ``sparse_linear(format=channelcompact)`` + ``gather_channels``
      glue node (folded into the next layer by :func:`fold_gathers`).
    * Block   -> ``sparse_linear(format=pbcsr)`` with reorder bands; the
      output block-column permutation is recorded as a ``gather_channels``
      glue node (foldable) when it is not the identity.
    * any conv structure (pattern / column-as-channel) -> masked conv whose
      fully-dead input channels are compacted away (``format=channelcompact``
      + a ``kept`` param): the conv kernel gathers the live channels and
      contracts a K shrunk by the pruned ratio.

    ``max_bands`` caps the reorder bands of the Block rule.
    """
    for stale in list(g.nodes):
        if stale.name not in masks or masks[stale.name] is None:
            continue
        # re-fetch: earlier iterations may have rewired this node's inputs
        node = g.node(stale.name)
        st = structures[node.name]
        mask = masks[node.name]
        p = g.params[node.name]
        if node.op == "linear":
            w = p["w"] * mask.to(p["w"].dtype)
            if isinstance(st, Column):
                fmt = ColumnCompact.from_dense(w, mask)
                g.params[node.name] = {
                    "values": fmt.values,
                    "kept": fmt.kept,
                    **({"b": p["b"]} if "b" in p else {}),
                }
                g = g.replace_node(
                    node.name,
                    node.replace(
                        op="sparse_linear",
                        attrs={**node.attrs, "format": "colcompact", "k_full": w.shape[0]},
                    ),
                )
            elif isinstance(st, Channel):
                fmt = ChannelCompact.from_dense(w, mask)
                bias = p.get("b")
                g.params[node.name] = {
                    "values": fmt.values,
                    **({"b": bias.index_select(0, fmt.kept)} if bias is not None else {}),
                }
                # glue: scatter back to full width unless folded away
                glue = Node(
                    op="gather_channels",
                    name=node.name + "_scatter",
                    inputs=(node.name,),
                    attrs={"mode": "scatter", "idx": fmt.kept.cpu().numpy(), "n": w.shape[1]},
                )
                g = g.replace_node(
                    node.name,
                    node.replace(
                        op="sparse_linear",
                        attrs={**node.attrs, "format": "channelcompact"},
                    ),
                )
                g = _insert_after(g, node.name, glue)
            elif isinstance(st, Block):
                bmask = block_mask(mask, st.bm, st.bn).cpu().numpy()
                plan = plan_reorder(bmask, max_bands=max_bands, bm=st.bm, bn=st.bn)
                w_perm = apply_column_perm(w, plan.order, st.bn)
                m_perm = apply_column_perm(mask, plan.order, st.bn)
                fmt = PBCSR.from_dense(w_perm, m_perm, st.bm, st.bn)
                bias = p.get("b")
                elem_order = (
                    np.asarray(plan.order)[:, None] * st.bn + np.arange(st.bn)[None, :]
                ).reshape(-1)
                if bias is not None:
                    bias = bias.index_select(0, torch.as_tensor(elem_order, device=bias.device))
                g.params[node.name] = {
                    "values": fmt.values,
                    "block_rows": fmt.block_rows,
                    **({"b": bias} if bias is not None else {}),
                }
                g = g.replace_node(
                    node.name,
                    node.replace(
                        op="sparse_linear",
                        attrs={
                            **node.attrs,
                            "format": "pbcsr",
                            "bands": tuple((b.start, b.stop, b.count) for b in plan.bands),
                            "bn": st.bn,
                        },
                    ),
                )
                if not plan.identity:
                    # undo the column permutation for consumers (foldable)
                    inv = np.empty_like(elem_order)
                    inv[elem_order] = np.arange(len(elem_order))
                    glue = Node(
                        op="gather_channels",
                        name=node.name + "_unperm",
                        inputs=(node.name,),
                        attrs={"mode": "gather", "idx": inv, "n": w.shape[1]},
                    )
                    g = _insert_after(g, node.name, glue)
            else:  # masked dense fallback (NM, bank, unstructured)
                g.params[node.name] = {**p, "w": w}
        elif node.op == "conv2d":
            # apply the mask, then *compact away* input channels that died
            # across all filters; the compaction folds into the conv node
            # itself (format="channelcompact" + a ``kept`` param) -- no glue
            # node, no extra plan step
            w = p["w"] * mask.to(p["w"].dtype)
            g.params[node.name] = {**p, "w": w}
            dead_in = torch.all(mask == 0, dim=(0, 2, 3))
            if bool(dead_in.any()) and not bool(dead_in.all()):
                kept = torch.nonzero(~dead_in).flatten().to(torch.int32)
                g.params[node.name] = {
                    **g.params[node.name],
                    "w": w.index_select(1, kept),
                    "kept": kept,
                }
                g = g.replace_node(
                    node.name,
                    node.replace(attrs={**node.attrs, "format": "channelcompact"}),
                )
        else:
            w = p["w"] * mask.to(p["w"].dtype)
            g.params[node.name] = {**p, "w": w}
    g.validate()
    return g


def _insert_after(g: Graph, name: str, glue: Node) -> Graph:
    """Insert ``glue`` (consuming ``name``) between node and its consumers."""
    g = g.rewire(name, glue.name)
    # rewire also rewrote glue's own input; restore it
    nodes = []
    for n in g.nodes:
        if n.name == glue.name:
            continue
        nodes.append(n)
        if n.name == name:
            nodes.append(glue.replace(inputs=(name,)))
    if glue.name not in [n.name for n in nodes]:  # name was a graph input
        nodes.insert(0, glue.replace(inputs=(name,)))
    return dataclasses.replace(g, nodes=nodes)


# --------------------------------------------------------------------------- #
# 4. gather folding                                                            #
# --------------------------------------------------------------------------- #


def fold_gathers(g: Graph) -> Graph:
    """Fold ``gather_channels`` glue into the next linear's weight rows:
    gather(y, idx) @ W == y @ W_expanded  (scatter mode: rows placed at idx;
    gather mode: rows selected by idx).  Zero runtime cost -- the paper's
    offline reorder trick."""
    for node in list(g.nodes):
        if node.op != "gather_channels" or node.attrs.get("axis", -1) == 1:
            continue
        consumers = g.consumers(node.name)
        if len(consumers) != 1 or consumers[0].op != "linear":
            continue
        nxt = consumers[0]
        w = g.params[nxt.name]["w"]
        idx = torch.as_tensor(np.asarray(node.attrs["idx"]), device=w.device).long()
        if node.attrs["mode"] == "scatter":
            # y_full = scatter(y_compact, idx); y_full @ W == y_compact @ W[idx]
            w_new = w[idx]
        else:
            # y_perm = y[idx] (idx a permutation of 0..n-1, len == K of next W);
            # y_perm @ W == y @ W_scat with W_scat[idx[j]] = W[j].
            if int(idx.shape[0]) != int(w.shape[0]):
                continue
            w_new = w.new_zeros((node.attrs["n"], w.shape[1]))
            w_new[idx] = w
        g.params[nxt.name] = {**g.params[nxt.name], "w": w_new}
        g = g.without({node.name}).rewire(node.name, node.inputs[0])
    g.validate()
    return g


# --------------------------------------------------------------------------- #
# 5. elementwise-chain fusion                                                  #
# --------------------------------------------------------------------------- #

_EW_OPS = ("activation", "add", "mul")


def _is_elementwise(n: Node) -> bool:
    return n.op in _EW_OPS or (n.op == "norm" and n.attrs.get("kind") == "layer")


def fuse_elementwise(g: Graph) -> Graph:
    """Collapse straight-line runs of memory-bound elementwise ops
    (``add``/``mul``/``activation``/``norm(layer)``) into one
    ``fused_elementwise`` node carrying a ``steps`` program:

    * ``("activation", fn)``
    * ``("add", i)`` / ``("mul", i)`` -- ``i`` indexes the fused node's
      ``inputs`` tuple (the side operand of the binary op)
    * ``("norm_layer", pkey, eps)`` -- layernorm whose scale/bias live in the
      fused node's params under ``{pkey}_scale`` / ``{pkey}_bias``

    The fused node keeps the *last* chain member's name, so consumers and
    graph outputs are untouched: one kernel launch instead of k, one trip
    through memory instead of k.
    """
    outputs = set(g.outputs)
    merged: set = set()
    chains: List[List[Node]] = []
    for n in g.nodes:
        if n.name in merged or not _is_elementwise(n):
            continue
        chain = [n]
        while True:
            cur = chain[-1]
            if cur.name in outputs:
                break
            cons = g.consumers(cur.name)
            if len(cons) != 1:
                break
            nxt = cons[0]
            if (
                not _is_elementwise(nxt)
                or nxt.name in merged
                or nxt.inputs.count(cur.name) != 1
            ):
                break
            chain.append(nxt)
        if len(chain) >= 2:
            chains.append(chain)
            merged.update(c.name for c in chain)

    if not chains:
        return g

    nodes = list(g.nodes)
    params = dict(g.params)
    for chain in chains:
        head, tail = chain[0], chain[-1]
        fused_inputs: List[str] = [head.inputs[0]]
        fused_params: Dict[str, Any] = {}
        steps: List[Tuple[Any, ...]] = []

        def side_index(name: str) -> int:
            if name not in fused_inputs:
                fused_inputs.append(name)
            return fused_inputs.index(name)

        prev_name = None  # chain value flows implicitly; head consumes inputs[0]
        for j, c in enumerate(chain):
            if c.op == "activation":
                steps.append(("activation", c.attrs["fn"]))
            elif c.op in ("add", "mul"):
                sides = list(c.inputs)
                if prev_name is not None:
                    sides.remove(prev_name)
                else:
                    sides = sides[1:]  # head: inputs[0] is the chain entry
                steps.append((c.op, side_index(sides[0])))
            else:  # norm(layer)
                pkey = f"s{j}"
                p = params.pop(c.name)
                fused_params[f"{pkey}_scale"] = p["scale"]
                fused_params[f"{pkey}_bias"] = p["bias"]
                steps.append(("norm_layer", pkey, c.attrs.get("eps", 1e-5)))
            prev_name = c.name

        fused = Node(
            op="fused_elementwise",
            name=tail.name,
            inputs=tuple(fused_inputs),
            attrs={"steps": tuple(steps)},
        )
        drop = {c.name for c in chain[:-1]}
        nodes = [fused if n.name == tail.name else n for n in nodes if n.name not in drop]
        for d in drop:
            params.pop(d, None)
        if fused_params:
            params[tail.name] = fused_params
    g = dataclasses.replace(g, nodes=nodes, params=params)
    g.validate()
    return g


# --------------------------------------------------------------------------- #
# 5b. GEMM epilogue-program fusion                                             #
# --------------------------------------------------------------------------- #

#: producers whose handlers execute an ``epilogue`` attr (see executor.py)
_EPI_PRODUCERS = ("linear", "sparse_linear", "conv2d")


def _epilogue_candidate(g: Graph, n: Node):
    """If ``n`` is an elementwise follower foldable into a GEMM/conv producer,
    return ``(src_name, raw_steps)`` where raw steps carry side operands as
    *names* (resolved to input slots by the caller) and norm params as
    ``("param", scale, bias)`` markers.  Else return None."""
    if n.op == "activation":
        return n.inputs[0], [("activation", n.attrs["fn"])]
    if n.op in ("add", "mul"):
        if len(set(n.inputs)) != 2:
            return None  # y+y consumes the producer twice; not a single edge
        a_name, b_name = n.inputs

        def foldable(name):
            try:
                nd = g.node(name)
            except KeyError:
                return False
            return (
                nd.op in _EPI_PRODUCERS
                and len(g.consumers(name)) == 1
                and name not in g.outputs
            )

        src = a_name if foldable(a_name) else (b_name if foldable(b_name) else None)
        if src is None:
            return None
        side = b_name if src == a_name else a_name
        return src, [(n.op, ("side", side))]
    if n.op == "norm" and n.attrs.get("kind") in ("instance", "layer"):
        p = g.params.get(n.name, {})
        kind = "norm_instance" if n.attrs["kind"] == "instance" else "norm_layer"
        return n.inputs[0], [
            (kind, ("param", p["scale"], p["bias"]), n.attrs.get("eps", 1e-5))
        ]
    if n.op == "rmsnorm":
        p = g.params.get(n.name, {})
        return n.inputs[0], [
            ("norm_rms", ("param", p["scale"], None), n.attrs.get("eps", 1e-6))
        ]
    if n.op == "rope":
        return n.inputs[0], [
            ("rope", ("side", n.inputs[1]), n.attrs["heads"],
             n.attrs.get("theta", 10000.0))
        ]
    if n.op == "fused_elementwise":
        if n.inputs.count(n.inputs[0]) != 1:
            return None
        steps = []
        p = g.params.get(n.name, {})
        for step in n.attrs["steps"]:
            kind = step[0]
            if kind == "activation":
                steps.append(step)
            elif kind in ("add", "mul"):
                if step[1] == 0:
                    return None  # references the producer's raw output
                steps.append((kind, ("side", n.inputs[step[1]])))
            elif kind == "norm_layer":
                pkey, eps = step[1], step[2]
                steps.append(
                    ("norm_layer", ("param", p[f"{pkey}_scale"], p[f"{pkey}_bias"]), eps)
                )
            else:
                return None
        return n.inputs[0], steps
    return None


def fuse_epilogue(g: Graph) -> Graph:
    """Fold an elementwise follower (``activation``/``add``/``mul``/
    ``norm(instance|layer)``/``rmsnorm``/``rope``/``fused_elementwise``) into
    its GEMM/conv producer's **epilogue program** -- a ``("epilogue", ...)``
    attr executed by the producer's handler: inside the kernel for
    activation / add / mul on output-shaped sides, as a post-kernel tail
    for norm and rope steps (still one plan step instead of two).

    The fused node takes the *follower's* name, so consumers and graph
    outputs are untouched.  Epilogue side slots index the fused node's own
    ``inputs`` tuple; norm scale/bias move into its params under fresh
    ``e{i}_scale`` / ``e{i}_bias`` keys.  Runs to fixpoint, so
    conv -> IN -> relu -> add collapses into one node."""
    changed = True
    while changed:
        changed = False
        for n in list(g.nodes):
            cand = _epilogue_candidate(g, n)
            if cand is None:
                continue
            src_name, raw_steps = cand
            if n.inputs.count(src_name) != 1 or src_name in g.outputs:
                continue
            try:
                src = g.node(src_name)
            except KeyError:
                continue  # producer is a graph input
            if src.op not in _EPI_PRODUCERS or len(g.consumers(src_name)) != 1:
                continue
            if any(
                step[0] == "norm_instance" for step in raw_steps
            ) and src.op != "conv2d":
                continue  # instance norm is NCHW-only

            params = dict(g.params)
            new_params = dict(params.pop(src_name, {}))
            epi = list(src.attrs.get("epilogue", ()))
            n_norm = sum(s[0].startswith("norm") for s in epi)
            new_inputs = list(src.inputs)
            steps: List[Tuple[Any, ...]] = []
            for step in raw_steps:
                kind = step[0]
                if kind == "activation":
                    steps.append(step)
                elif kind in ("add", "mul"):
                    side = step[1][1]
                    if side not in new_inputs:
                        new_inputs.append(side)
                    steps.append((kind, new_inputs.index(side)))
                elif kind == "rope":  # position ids become a side operand
                    side = step[1][1]
                    if side not in new_inputs:
                        new_inputs.append(side)
                    steps.append((kind, new_inputs.index(side), *step[2:]))
                else:  # norm_layer / norm_instance / norm_rms
                    _, scale, bias = step[1]
                    pkey = f"e{n_norm}"
                    n_norm += 1
                    new_params[f"{pkey}_scale"] = scale
                    if bias is not None:  # rms norm: scale only
                        new_params[f"{pkey}_bias"] = bias
                    steps.append((kind, pkey, step[2]))
            params.pop(n.name, None)  # follower params absorbed above
            params[n.name] = new_params
            fused = Node(
                op=src.op,
                name=n.name,
                inputs=tuple(new_inputs),
                attrs={**src.attrs, "epilogue": tuple(epi) + tuple(steps)},
            )
            nodes = []
            for nd in g.nodes:
                if nd.name == src_name:
                    continue
                nodes.append(fused if nd.name == n.name else nd)
            g = dataclasses.replace(g, nodes=nodes, params=params)
            changed = True
            break  # node list changed: restart the scan
    g.validate()
    return g


# --------------------------------------------------------------------------- #
# 5c. weight quantization                                                      #
# --------------------------------------------------------------------------- #

#: sparse formats whose packed values are plain [K', N'] matrices -- these
#: ride the qmatmul path.  pbcsr values are 4-D packed blocks, so pbcsr
#: nodes stay f32.
_QUANT_SPARSE_FORMATS = ("colcompact", "channelcompact")


def quantize(
    g: Graph,
    calibration=None,
    *,
    skip: Tuple[str, ...] = (),
    act_skip: Tuple[str, ...] = (),
) -> Graph:
    """Rewrite GEMM/conv nodes to INT8-stored quantized ops (symmetric
    per-output-channel absmax, :class:`repro_torch.quant.qtensor.QTensor`
    layout).

    * ``linear`` / ``sparse_linear(colcompact|channelcompact)`` ->
      ``qlinear``: int8 ``values`` + f32 ``w_scale[N]``.  When
      ``calibration`` (a :class:`~repro_torch.quant.calibrate.CalibrationTable`)
      has an activation range for the node's input, the node is tagged
      ``scheme="w8a8"`` with the static ``x_scale`` (int8 x int8 sums in the
      kernel); otherwise ``scheme="w8"`` keeps f32 activations.
    * ``conv2d`` -> ``qconv2d``: int8 filters executed by the INT8
      implicit-GEMM conv kernel, with the same W8A8-vs-W8 election.
      Channel-compact convs keep their ``kept`` indices (the gather
      preserves values, so the input's scale applies to the gathered
      activations too).
    * ``sparse_linear(pbcsr)`` is left untouched (blocked payload), as is
      any node named in ``skip`` (keep the first/last layers f32).  Nodes
      named in ``act_skip`` still quantize their weights but are pinned to
      ``scheme="w8"`` even when calibrated -- the mixed-precision knob for
      residual trunks, where static activation quantization noise
      accumulates across blocks (see ``models/cnn.py:APP_ACT_SKIP``).

    Every rewritten node is annotated with ``bytes_saved`` (dense f32 bytes
    minus int8 payload + scales), which
    :meth:`ExecutionPlan.memory_estimate` sums as ``weight_bytes_saved``.
    Runs after ``fuse_epilogue`` so epilogue attrs (and their
    ``e{i}_scale``/``e{i}_bias`` params, which are kept) are attached.
    """
    g = dataclasses.replace(g, nodes=list(g.nodes), params=dict(g.params))

    def elect_scheme(node) -> Dict[str, Any]:
        """The one W8A8-vs-W8 policy shared by linear and conv rewrites:
        upgrade iff the node's input range is calibrated and its activations
        are not pinned to f32 by ``act_skip``."""
        x_scale = (
            calibration.get_scale(node.inputs[0])
            if calibration is not None and node.name not in act_skip
            else None
        )
        if x_scale is None:
            return {"scheme": "w8"}
        return {"scheme": "w8a8", "x_scale": float(x_scale)}

    def packed(p, wkey, axis):
        w = p[wkey]
        qt = QTensor.from_float(w, axis=axis)  # per output channel
        saved = w.numel() * w.element_size() - qt.nbytes
        # keep every non-weight param (bias, gather indices, epilogue norm
        # scale/bias) alongside the packed payload
        params = {**{k: v for k, v in p.items() if k != wkey},
                  "values": qt.values, "w_scale": qt.scale}
        return params, int(saved)

    nodes = []
    for node in g.nodes:
        if node.name in skip:
            nodes.append(node)
            continue
        p = g.params.get(node.name, {})
        is_qlinear = node.op == "linear" or (
            node.op == "sparse_linear"
            and node.attrs.get("format") in _QUANT_SPARSE_FORMATS
        )
        if is_qlinear:
            g.params[node.name], saved = packed(p, "w" if node.op == "linear" else "values", 1)
            attrs = {
                **node.attrs,
                "format": node.attrs.get("format", "dense"),
                "bytes_saved": saved,
                **elect_scheme(node),
            }
            nodes.append(node.replace(op="qlinear", attrs=attrs))
        elif node.op == "conv2d" and "w" in p:
            g.params[node.name], saved = packed(p, "w", 0)
            attrs = {**node.attrs, "bytes_saved": saved, **elect_scheme(node)}
            nodes.append(node.replace(op="qconv2d", attrs=attrs))
        else:
            nodes.append(node)
    g = dataclasses.replace(g, nodes=nodes)
    g.validate()
    return g


# --------------------------------------------------------------------------- #
# 6. common-subexpression elimination                                          #
# --------------------------------------------------------------------------- #


def _attr_key(v: Any) -> Any:
    """Hashable fingerprint of an attrs value (arrays by content)."""
    if isinstance(v, dict):
        return ("dict",) + tuple(sorted((k, _attr_key(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return ("seq",) + tuple(_attr_key(x) for x in v)
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    if isinstance(v, np.ndarray):
        return ("arr", v.shape, str(v.dtype), v.tobytes())
    return v


def cse(g: Graph) -> Graph:
    """Deduplicate nodes computing the same value: identical op, (resolved)
    inputs and attrs, and -- for parameterized nodes -- the *same* parameter
    tensors (identity, not value equality: cheap and never wrong)."""
    seen: Dict[Any, str] = {}
    replaced: Dict[str, str] = {}
    keep: List[Node] = []
    params = dict(g.params)
    for n in g.nodes:
        inputs = tuple(replaced.get(i, i) for i in n.inputs)
        pfp = tuple(sorted((k, id(v)) for k, v in g.params.get(n.name, {}).items()))
        key = (n.op, inputs, _attr_key(n.attrs), pfp)
        if n.op != "input" and key in seen:
            replaced[n.name] = seen[key]
            params.pop(n.name, None)
            continue
        seen.setdefault(key, n.name)
        keep.append(n.replace(inputs=inputs))
    if not replaced:
        return g
    outputs = tuple(replaced.get(o, o) for o in g.outputs)
    g = dataclasses.replace(g, nodes=keep, outputs=outputs, params=params)
    g.validate()
    return g


# --------------------------------------------------------------------------- #
# 7. dead code elimination                                                     #
# --------------------------------------------------------------------------- #


def dce(g: Graph) -> Graph:
    live = set(g.outputs)
    changed = True
    by_name = {n.name: n for n in g.nodes}
    while changed:
        changed = False
        for name in list(live):
            n = by_name.get(name)
            if n is None:
                continue
            for i in n.inputs:
                if i not in live:
                    live.add(i)
                    changed = True
    dead = {n.name for n in g.nodes if n.name not in live}
    return g.without(dead)


# --------------------------------------------------------------------------- #
# registration + pipeline                                                      #
# --------------------------------------------------------------------------- #

from .pass_manager import (  # noqa: E402  (registry must exist before passes)
    PassContext,
    PassManager,
    no_dead_nodes,
    no_foldable_batchnorm,
    params_bound_to_nodes,
    register_pass,
)

register_pass("fold_norm", post=(no_foldable_batchnorm, params_bound_to_nodes))(
    lambda g, ctx: fold_norm(g)
)
register_pass("fuse_activation", post=(params_bound_to_nodes,))(
    lambda g, ctx: fuse_activation(g)
)
register_pass("substitute_sparse", needs_masks=True, post=(params_bound_to_nodes,))(
    lambda g, ctx: substitute_sparse(
        g, ctx.masks, ctx.structures, max_bands=ctx.max_bands
    )
)
register_pass("fold_gathers", needs_masks=True, post=(params_bound_to_nodes,))(
    lambda g, ctx: fold_gathers(g)
)
register_pass("cse", post=(params_bound_to_nodes,))(lambda g, ctx: cse(g))
register_pass("fuse_elementwise", post=(params_bound_to_nodes,))(
    lambda g, ctx: fuse_elementwise(g)
)
register_pass("fuse_epilogue", post=(params_bound_to_nodes,))(
    lambda g, ctx: fuse_epilogue(g)
)
register_pass("quantize", needs_calibration=True, post=(params_bound_to_nodes,))(
    lambda g, ctx: quantize(
        g, ctx.calibration, skip=tuple(ctx.quant_skip),
        act_skip=tuple(ctx.act_quant_skip),
    )
)
register_pass("dce", post=(no_dead_nodes, params_bound_to_nodes))(lambda g, ctx: dce(g))


def optimize(
    g: Graph,
    masks: Optional[Dict[str, Any]] = None,
    structures: Optional[Dict[str, Structure]] = None,
    *,
    max_bands: int = 4,
    pipeline: Optional[Tuple[str, ...]] = None,
) -> Graph:
    """The full deployment pipeline (paper's compiler, end to end): a thin
    wrapper over :class:`~.pass_manager.PassManager` -- pass ``pipeline`` to
    run a custom ordered subset of registered passes."""
    ctx = PassContext(masks=masks or {}, structures=structures or {}, max_bands=max_bands)
    return PassManager(pipeline).run(g, ctx)
