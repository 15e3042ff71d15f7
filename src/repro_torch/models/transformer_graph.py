"""Decoder-block lowering: ``models/transformer.py`` params -> graph IR (a port
of ``repro.models.transformer_graph``: the same nodes, names and order).

This is the bridge between the model stack and the plan compiler: a
dense GQA decoder (the qwen-family shape) becomes a :class:`Graph` of
registered executor ops, so the whole PassManager pipeline (epilogue fusion,
CSE, DCE -- and quantize/sparsify when calibrated) applies to autoregressive
inference exactly as it does to the CNN demo apps.

Two phases, two graphs (an autoregressive server compiles both):

* ``phase="prefill"``: inputs ``(tokens [B, S], positions [B, S],
  lengths [B])`` -> outputs ``(logits [B, S, V_pad], k_rope_0, v_0, ...,
  k_rope_{L-1}, v_{L-1})`` with per-layer k/v as ``[B, S, G*dh]`` (k is
  post-RoPE -- the cache stores roped keys, matching ``gqa_prefill``).
  ``lengths`` masks each row to its own prompt inside the padded batch.
* ``phase="decode"``: inputs ``(tokens [B, 1], positions [B, 1],
  k_ctx [B, L, S, G, dh], v_ctx [B, L, S, G, dh], lengths [B])`` -> outputs
  ``(logits [B, 1, V_pad], k_rope_0, v_0, ...)`` with the fresh per-layer
  k/v as ``[B, 1, G*dh]``.  The attention op merges the fresh KV into the
  gathered cache span at slot == length -- ``gqa_decode_step`` semantics
  over a paged gather instead of a ring buffer.

The lowering is *op-per-layer-component* on purpose: RoPE and the residual
adds/final norm start as standalone nodes and the ``fuse_epilogue`` pass
folds them into their producing GEMMs (rope -> q/k projections, residual
add -> w_o/w_down, final rmsnorm -> the last w_down), which is the
measurable plan-step reduction (9 nodes a layer + 2 after ``optimize``).
"""

from __future__ import annotations

from typing import Any, Dict

from ..configs.base import ArchConfig
from ..core.graph.ir import Graph, GraphBuilder
from .transformer import block_kinds

__all__ = ["build_decoder_graph", "decoder_cache_spec"]

Params = Dict[str, Any]


def decoder_cache_spec(cfg: ArchConfig) -> Dict[str, int]:
    """The per-token KV footprint the paged cache must provision:
    ``n_layers x n_kv_heads x head_dim`` per token for each of k and v."""
    return {
        "n_layers": cfg.n_layers,
        "n_kv_heads": cfg.n_kv_heads,
        "head_dim": cfg.resolved_head_dim,
    }


def check_config(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` (the JAX package's messages) for a
    config the decoder lowering does not take: anything but dense GQA blocks
    without qk_norm, MoE, a vision prefix or an encoder."""
    kinds = set(block_kinds(cfg))
    if kinds != {"attn"}:
        raise NotImplementedError(
            f"decoder lowering supports dense GQA blocks only, got {kinds}"
        )
    if cfg.kv_lora_rank:
        raise NotImplementedError("MLA attention is not lowered yet")
    if cfg.qk_norm:
        raise NotImplementedError("qk_norm is not lowered yet")
    if cfg.moe is not None or cfg.vision_tokens or cfg.is_encdec:
        raise NotImplementedError("MoE/VLM/enc-dec configs are not lowered")


def _check_supported(params: Params, cfg: ArchConfig) -> None:
    check_config(cfg)
    layer0 = params["layers"][0]
    if "w" not in layer0["attn"]["w_q"] or "w" not in layer0["ffn"]["w_gate"]:
        raise NotImplementedError(
            "pruned/packed decoder params are not lowered yet (dense 'w' only)"
        )


def _linear_params(p: Params) -> Params:
    out = {"w": p["w"]}
    if "b" in p:
        out["b"] = p["b"]
    return out


def build_decoder_graph(
    params: Params, cfg: ArchConfig, *, phase: str = "prefill"
) -> Graph:
    """Lower ``init_lm`` params into an executable decoder graph for one
    phase.  Pass the result through ``passes.optimize`` before
    ``compile_plan`` to get the fused production plan."""
    if phase not in ("prefill", "decode"):
        raise ValueError(f"phase must be prefill|decode, got {phase!r}")
    _check_supported(params, cfg)
    decode = phase == "decode"
    h, g = cfg.n_heads, cfg.n_kv_heads
    theta = cfg.rope_theta
    eps = cfg.norm_eps

    inputs = ["tokens", "positions"]
    if decode:
        inputs += ["k_ctx", "v_ctx"]
    inputs.append("lengths")
    b = GraphBuilder(inputs)

    x = b.add("embed", "tokens", name="embed",
              params={"table": params["embed"]["table"]})
    outputs = ["logits"]
    for i, lp in enumerate(params["layers"]):
        hn = b.add("rmsnorm", x, name=f"norm1_{i}",
                   params={"scale": lp["norm1"]["scale"]}, eps=eps)
        ap = lp["attn"]
        q = b.add("linear", hn, name=f"q_{i}", params=_linear_params(ap["w_q"]))
        k = b.add("linear", hn, name=f"k_{i}", params=_linear_params(ap["w_k"]))
        v = b.add("linear", hn, name=f"v_{i}", params=_linear_params(ap["w_v"]))
        qr = b.add("rope", (q, "positions"), name=f"q_rope_{i}",
                   heads=h, theta=theta)
        kr = b.add("rope", (k, "positions"), name=f"k_rope_{i}",
                   heads=g, theta=theta)
        attn_inputs = (
            (qr, kr, v, "k_ctx", "v_ctx", "lengths") if decode
            else (qr, kr, v, "lengths")
        )
        attrs: Dict[str, Any] = dict(
            phase=phase, n_heads=h, n_kv_heads=g,
        )
        if decode:
            attrs["layer"] = i
        at = b.add("attention", attn_inputs, name=f"attn_{i}", **attrs)
        o = b.add("linear", at, name=f"o_{i}", params=_linear_params(ap["w_o"]))
        x1 = b.add("add", (o, x), name=f"res1_{i}")
        h2 = b.add("rmsnorm", x1, name=f"norm2_{i}",
                   params={"scale": lp["norm2"]["scale"]}, eps=eps)
        gu = b.add("ffn", h2, name=f"gu_{i}",
                   params={"w_gate": lp["ffn"]["w_gate"]["w"],
                           "w_up": lp["ffn"]["w_up"]["w"]},
                   activation=cfg.ffn_activation)
        dn = b.add("linear", gu, name=f"down_{i}",
                   params=_linear_params(lp["ffn"]["w_down"]))
        x = b.add("add", (dn, x1), name=f"res2_{i}")
        outputs += [kr, v]

    fin = b.add("rmsnorm", x, name="final_norm",
                params={"scale": params["final_norm"]["scale"]}, eps=eps)
    if cfg.tie_embeddings:
        w_out = params["embed"]["table"].T
    else:
        w_out = params["lm_head"]["w"]
    b.add("unembed", fin, name="logits", params={"w": w_out},
          vocab=cfg.vocab)
    return b.build(outputs)
