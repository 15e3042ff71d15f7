"""The paper's three demo applications as LR-DSL graphs (a port of
``repro.models.cnn``: the same graphs, node names, attrs and param shapes).

* **style transfer** -- MSG-Net-style generator (Zhang & Dana 2017): conv-in
  -> downsample convs -> residual blocks (instance norm) -> upsample convs
  -> conv-out.  Pruned with **column pruning** (paper).
* **coloring** -- Iizuka et al. 2016: low-level conv stack -> {mid-level,
  global} branches -> fusion (global feature broadcast + 1x1 conv) ->
  decoder with upsampling.  Pruned with **kernel-pattern pruning** (paper).
* **super resolution** -- WDSR-style (Yu et al. 2018): wide-activation
  residual blocks + pixel-shuffle upsample.  **Kernel-pattern pruning**.

Each builder draws its weights from a ``torch.Generator`` (on the CPU, so a
seed gives the same weights on every device) or takes carried-over params
(``params=``, e.g. the JAX package's, as numpy), and places them on
``device`` (``None`` means ``cuda``; without a GPU that raises).
``jax.random`` draws cannot be reproduced here, so the port's tests carry
the reference's params across.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional

import torch

from ..convert import DeviceLike, params_from_numpy, resolve_device
from ..core.graph.ir import Graph, GraphBuilder

__all__ = [
    "APPS",
    "APP_INPUT_CHANNELS",
    "APP_ACT_SKIP",
    "APP_QUANT_SKIP",
    "PAPER_RECIPE",
    "PAPER_TABLE1",
    "app_masks",
    "build_coloring",
    "build_style_transfer",
    "build_super_resolution",
]


class _Draws:
    """Weight source of one builder call: CPU-generator draws moved to the
    target device (bit-identical across devices for a given seed)."""

    def __init__(self, generator: Optional[torch.Generator], device: torch.device):
        self.gen = generator if generator is not None else torch.Generator().manual_seed(0)
        self.device = device

    def normal(self, shape, scale: float) -> torch.Tensor:
        return (torch.randn(shape, generator=self.gen) * scale).to(self.device)

    def zeros(self, n: int) -> torch.Tensor:
        return torch.zeros((n,), device=self.device)

    def ones(self, n: int) -> torch.Tensor:
        return torch.ones((n,), device=self.device)

    def conv(self, c_out: int, c_in: int, k: int, bias: bool = True) -> Dict[str, torch.Tensor]:
        p = {"w": self.normal((c_out, c_in, k, k), 1.0 / math.sqrt(c_in * k * k))}
        if bias:
            p["b"] = self.zeros(c_out)
        return p

    def bn(self, c: int) -> Dict[str, torch.Tensor]:
        return {"scale": self.ones(c), "bias": self.zeros(c), "mean": self.zeros(c),
                "var": self.ones(c)}

    def inorm(self, c: int) -> Dict[str, torch.Tensor]:
        return {"scale": self.ones(c), "bias": self.zeros(c)}


def _finish(b: GraphBuilder, out: str, params: Optional[Mapping[str, Mapping[str, Any]]],
            device: torch.device) -> Graph:
    """Build the graph; swap in carried-over params (same nodes, keys and
    shapes as the drawn ones) when given."""
    g = b.build(out)
    if params is None:
        return g
    carried = params_from_numpy(params, device)
    if set(carried) != set(g.params):
        raise ValueError(f"carried params cover {sorted(carried)}, graph has {sorted(g.params)}")
    for node, p in g.params.items():
        got = {k: tuple(v.shape) for k, v in carried[node].items()}
        want = {k: tuple(v.shape) for k, v in p.items()}
        if got != want:
            raise ValueError(f"carried params of {node}: {got} != {want}")
    g.params = carried
    return g


# --------------------------------------------------------------------------- #
# style transfer                                                               #
# --------------------------------------------------------------------------- #


def build_style_transfer(
    generator: Optional[torch.Generator] = None, base: int = 32, n_res: int = 5, *,
    params: Optional[Mapping[str, Mapping[str, Any]]] = None, device: DeviceLike = None,
) -> Graph:
    """conv7-IN-relu, 2x downsample conv3 s2, n_res residual blocks (1x1
    entry conv + 3x3 body, MSG-Net bottleneck style), 2x upsample, conv7-out.
    Input [N, 3, H, W]."""
    dev = resolve_device(device)
    d = _Draws(generator, dev)
    b = GraphBuilder(["x"])
    h = b.add("conv2d", "x", name="conv_in", params=d.conv(base, 3, 7), stride=1)
    h = b.add("norm", h, name="in_in", params=d.inorm(base), kind="instance")
    h = b.add("activation", h, name="act_in", fn="relu")
    c = base
    for i in range(2):  # downsample
        h = b.add("conv2d", h, name=f"down{i}", params=d.conv(c * 2, c, 3), stride=2)
        h = b.add("norm", h, name=f"down{i}_in", params=d.inorm(c * 2), kind="instance")
        h = b.add("activation", h, name=f"down{i}_act", fn="relu")
        c *= 2
    for i in range(n_res):  # residual blocks
        r = b.add("conv2d", h, name=f"res{i}_c1", params=d.conv(c, c, 1))
        r = b.add("norm", r, name=f"res{i}_n1", params=d.inorm(c), kind="instance")
        r = b.add("activation", r, name=f"res{i}_a1", fn="relu")
        r = b.add("conv2d", r, name=f"res{i}_c2", params=d.conv(c, c, 3))
        r = b.add("norm", r, name=f"res{i}_n2", params=d.inorm(c), kind="instance")
        h = b.add("add", (h, r), name=f"res{i}_add")
    for i in range(2):  # upsample
        h = b.add("upsample", h, name=f"up{i}_u", factor=2)
        h = b.add("conv2d", h, name=f"up{i}", params=d.conv(c // 2, c, 3))
        h = b.add("norm", h, name=f"up{i}_in", params=d.inorm(c // 2), kind="instance")
        h = b.add("activation", h, name=f"up{i}_act", fn="relu")
        c //= 2
    out = b.add("conv2d", h, name="conv_out", params=d.conv(3, c, 7))
    return _finish(b, out, params, dev)


# --------------------------------------------------------------------------- #
# coloring                                                                     #
# --------------------------------------------------------------------------- #


def build_coloring(
    generator: Optional[torch.Generator] = None, base: int = 32, *,
    params: Optional[Mapping[str, Mapping[str, Any]]] = None, device: DeviceLike = None,
) -> Graph:
    """Iizuka-style: low-level stack -> (mid branch, global branch) -> fusion
    -> decoder.  Input [N, 1, H, W] grayscale; output [N, 2, H, W] chroma."""
    dev = resolve_device(device)
    d = _Draws(generator, dev)
    b = GraphBuilder(["x"])

    def conv_bn_relu(h, c_out, c_in, name, stride=1, k=3):
        h = b.add("conv2d", h, name=name, params=d.conv(c_out, c_in, k), stride=stride)
        h = b.add("norm", h, name=name + "_bn", params=d.bn(c_out), kind="batch")
        return b.add("activation", h, name=name + "_act", fn="relu")

    # low-level features (strided)
    h = conv_bn_relu("x", base, 1, "low1", stride=2)
    h = conv_bn_relu(h, base * 2, base, "low2")
    h = conv_bn_relu(h, base * 2, base * 2, "low3", stride=2)
    h = conv_bn_relu(h, base * 4, base * 2, "low4")
    # mid-level branch
    mid = conv_bn_relu(h, base * 4, base * 4, "mid1")
    mid = conv_bn_relu(mid, base * 2, base * 4, "mid2")
    # global branch: strided convs -> global pool -> fc
    g = conv_bn_relu(h, base * 4, base * 4, "glob1", stride=2)
    g = conv_bn_relu(g, base * 4, base * 4, "glob2", stride=2)
    g = b.add("global_avg_pool", g, name="glob_pool")
    g = b.add("linear", g, name="glob_fc1",
              params={"w": d.normal((base * 4, base * 2), 0.05), "b": d.zeros(base * 2)})
    g = b.add("activation", g, name="glob_fc1_act", fn="relu")
    # fusion: broadcast global feature over mid map, concat, 1x1 conv
    gb = b.add("broadcast_spatial", (g, mid), name="glob_bcast")
    fused = b.add("concat", (mid, gb), name="fusion_cat", axis=1)
    h = conv_bn_relu(fused, base * 2, base * 4, "fuse1", k=1)
    # decoder
    h = conv_bn_relu(h, base, base * 2, "dec1")
    h = b.add("upsample", h, name="dec_up1", factor=2)
    h = conv_bn_relu(h, base, base, "dec2")
    h = b.add("upsample", h, name="dec_up2", factor=2)
    h = conv_bn_relu(h, base // 2, base, "dec3")
    out = b.add("conv2d", h, name="dec_out", params=d.conv(2, base // 2, 3))
    out = b.add("activation", out, name="dec_tanh", fn="tanh")
    return _finish(b, out, params, dev)


# --------------------------------------------------------------------------- #
# super resolution (WDSR-style)                                                #
# --------------------------------------------------------------------------- #


def build_super_resolution(
    generator: Optional[torch.Generator] = None, base: int = 32, n_res: int = 8,
    expand: int = 6, scale: int = 2, *,
    params: Optional[Mapping[str, Mapping[str, Any]]] = None, device: DeviceLike = None,
) -> Graph:
    """Wide-activation residual body + pixel shuffle.  Input [N, 3, H, W].
    Blocks are WDSR-B style: 1x1 expand (direct-GEMM conv fast path) ->
    relu -> 3x3 project."""
    dev = resolve_device(device)
    d = _Draws(generator, dev)
    b = GraphBuilder(["x"])
    h = b.add("conv2d", "x", name="head", params=d.conv(base, 3, 3))
    body_in = h
    for i in range(n_res):
        r = b.add("conv2d", h, name=f"res{i}_expand", params=d.conv(base * expand, base, 1))
        r = b.add("activation", r, name=f"res{i}_act", fn="relu")
        r = b.add("conv2d", r, name=f"res{i}_project", params=d.conv(base, base * expand, 3))
        h = b.add("add", (h, r), name=f"res{i}_add")
    h = b.add("add", (h, body_in), name="global_skip")
    h = b.add("conv2d", h, name="tail", params=d.conv(3 * scale * scale, base, 3))
    out = b.add("pixel_shuffle", h, name="shuffle", factor=scale)
    return _finish(b, out, params, dev)


APPS = {
    "style_transfer": build_style_transfer,
    "coloring": build_coloring,
    "super_resolution": build_super_resolution,
}

#: input channels of each app's frames
APP_INPUT_CHANNELS = {"style_transfer": 3, "coloring": 1, "super_resolution": 3}

#: the paper's pruning recipe per app (section 2: "column pruning for style
#: transfer and kernel pruning for coloring and super resolution")
PAPER_RECIPE = {
    "style_transfer": "column",
    "coloring": "pattern",
    "super_resolution": "pattern",
}

#: first/last layers the JAX package's ``quantize`` pass keeps at f32 (data
#: only here: the port's INT8 slice comes later)
APP_QUANT_SKIP = {
    "style_transfer": ("conv_in", "act_in", "conv_out"),
    "coloring": ("low1", "low1_act", "dec_out", "dec_tanh"),
    "super_resolution": ("head", "tail"),
}

#: nodes whose *activations* stay f32 under ``quantize`` (data only here)
APP_ACT_SKIP = {
    "style_transfer": tuple(
        [f"down{i}{s}" for i in range(2) for s in ("", "_act")]
        + [f"res{i}{s}" for i in range(8) for s in ("_c1", "_c2", "_a1", "_add")]
        + [f"up{i}{s}" for i in range(2) for s in ("", "_act")]
    ),
    "coloring": (),
    "super_resolution": tuple(
        [f"res{i}{s}" for i in range(8) for s in ("_expand", "_project", "_act", "_add")]
        + ["global_skip"]
    ),
}

#: Table 1 of the paper (ms on Samsung Galaxy S10, Adreno 640)
PAPER_TABLE1 = {
    "style_transfer": {"unpruned": 283.0, "pruned": 178.0, "pruned_compiler": 67.0},
    "coloring": {"unpruned": 137.0, "pruned": 85.0, "pruned_compiler": 38.0},
    "super_resolution": {"unpruned": 269.0, "pruned": 192.0, "pruned_compiler": 73.0},
}


# --------------------------------------------------------------------------- #
# the paper's pruning recipes on conv graphs                                   #
# --------------------------------------------------------------------------- #


def _channel_mask(w: torch.Tensor, keep_frac: float) -> torch.Tensor:
    """Kill the lowest-energy input channels entirely.  [Co, Ci, kh, kw]."""
    energy = (w.float() ** 2).sum(dim=(0, 2, 3))  # [Ci]
    ci = w.shape[1]
    n_keep = max(1, int(round(ci * keep_frac)))
    thresh = torch.sort(energy).values[ci - n_keep]
    return (energy >= thresh).to(w.dtype)[None, :, None, None] * torch.ones_like(w)


def _pattern_mask(w: torch.Tensor, connectivity_channels: float) -> torch.Tensor:
    """Per-kernel best pattern + channel-granular connectivity pruning."""
    from ..core.pruning import PatternKernel, project

    _, mask = project(w, PatternKernel())
    if connectivity_channels > 0:
        mask = mask * _channel_mask(w, 1.0 - connectivity_channels)
    return mask


def app_masks(g: Graph, app: str, sparsity: float = 0.5):
    """Masks + structure metadata per the paper's recipe for ``app``."""
    from ..core.pruning import Column, PatternKernel, project

    recipe = PAPER_RECIPE[app]
    masks, structures = {}, {}
    for node in g.nodes:
        w = g.params.get(node.name, {}).get("w")
        if w is None:
            continue
        if node.op == "conv2d":
            if w.shape[1] <= 4:  # never prune the image-input conv
                continue
            if recipe == "column":
                # column pruning at channel granularity (exploitable by the
                # channel-compacting conv kernel)
                masks[node.name] = _channel_mask(w, 1.0 - sparsity)
                structures[node.name] = Column(sparsity)
            else:
                if w.shape[2] != 3:
                    continue  # patterns are defined for 3x3 kernels
                masks[node.name] = _pattern_mask(w, sparsity)
                structures[node.name] = PatternKernel(connectivity=sparsity)
        elif node.op == "linear" and w.shape[0] >= 64:
            _, m = project(w, Column(sparsity))
            masks[node.name] = m
            structures[node.name] = Column(sparsity)
    return masks, structures
