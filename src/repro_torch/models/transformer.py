"""Generic decoder-only LM over the dense / MoE / SSM / hybrid / VLM families
(a port of ``repro.models.transformer``).

Every layer has a *block kind* (``block_kinds``):

* ``attn``       pre-norm GQA (or MLA) + pre-norm FFN (MLP or MoE)
* ``localattn``  the same with sliding-window attention
* ``mamba``      a single pre-norm Mamba-2 mixer (no FFN, as in Mamba)
* ``rec``        pre-norm RG-LRU recurrent block + pre-norm MLP (Griffin)

As in the JAX package, a hybrid's pattern names ``attn``, never
``localattn``, so RecurrentGemma's attention layers attend globally over a
``max_len`` cache (``ROADMAP.md`` C); the window code is there and held to
the JAX package at function level.  MLA replaces GQA when
``cfg.kv_lora_rank`` is set; layers from ``cfg.moe.first_dense`` on carry a
MoE FFN, whose router aux loss ``forward`` sums over layers.  A VLM's
``patch_embeds [B, P, D]`` go through ``vision_proj`` and are prepended to
the text (a bidirectional prefix-LM prefix); their positions are dropped
from the logits.

``forward`` runs whole sequences with plain torch ops; it is the reference
the plan-compiled decoder is held to.  Its memory knobs are the JAX
package's: ``remat`` checkpoints each block (``remat_policy`` "full"
recomputes the whole block in the backward, "dots" keeps the outputs of the
2-D matmuls -- JAX's ``dots_with_no_batch_dims_saveable``), ``attn_chunk``
is the KV chunk of the chunked attention, and ``layout_scan`` runs the
layers in ``scan_plan``'s groups.  Under
``cfg.prune.enabled`` the attention layers carry the paper's recipe as
packed params (block-pruned q/o for a ``bsr`` execution mode, column-pruned
FFN), which ``forward`` runs in plain torch (``bsr_xla`` / ``colpack_xla``),
as the JAX package does.  The serving trio ``prefill`` / ``init_cache`` /
``decode_step`` keeps one cache a layer: ``{"k", "v", "pos"}`` (GQA),
``{"c_kv", "k_rope", "pos"}`` (MLA), ``{"state", "conv"}`` (Mamba-2) or
``{"h", "conv"}`` (RG-LRU), every tensor batch-leading.

``loss_fn`` is the training loss (next-token cross entropy through an f32
``logsumexp``, plus ``router_aux_weight x aux`` for MoE), differentiated by
plain autograd as the JAX package differentiates its forward with plain
XLA: no kernel of the port runs in training.

``init_lm`` draws every weight from one ``torch.Generator`` on that
generator's device, in order (embedding, layers, lm_head, vision_proj):
pass a CUDA generator to draw a full-width model on the card.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils import checkpoint as ckpt

from ..configs.base import ArchConfig
from . import attention as attn_mod
from . import ffn as ffn_mod
from . import rglru as rglru_mod
from . import ssm as ssm_mod
from .layers import embed, init_embedding, init_linear, init_rmsnorm, linear, rmsnorm
from .sharding import (constrain, head_operands, logsumexp_pick, mesh_context, on_mixer,
                       place_cache, replicate_axis)

__all__ = ["block_kinds", "scan_plan", "checkpointed", "init_layer", "init_lm", "forward",
           "loss_fn", "prefill", "init_cache", "decode_step"]

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def model_dtype(cfg: ArchConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def block_kinds(cfg: ArchConfig) -> List[str]:
    if cfg.ssm is not None:
        return ["mamba"] * cfg.n_layers
    if cfg.recurrent is not None:
        pat = cfg.recurrent.pattern
        return [pat[i % len(pat)] for i in range(cfg.n_layers)]
    return ["attn"] * cfg.n_layers


def scan_plan(cfg: ArchConfig) -> Tuple[List[int], int, int, List[int]]:
    """Layer grouping of ``layout_scan``: ``(prefix_layers, unit_len,
    n_units, suffix_layers)``.  ``prefix`` and ``suffix`` are structurally
    distinct layers (DeepSeek's dense-FFN layers, a hybrid pattern's
    remainder); the middle ``n_units`` repeat the ``unit_len``-layer
    pattern, which the JAX package runs as one ``lax.scan`` over stacked
    params."""
    prefix: List[int] = []
    start = 0
    if cfg.moe is not None and cfg.moe.first_dense > 0:
        prefix = list(range(cfg.moe.first_dense))
        start = cfg.moe.first_dense
    unit = len(cfg.recurrent.pattern) if cfg.recurrent is not None else 1
    n_units = (cfg.n_layers - start) // unit
    suffix = list(range(start + n_units * unit, cfg.n_layers))
    return prefix, unit, n_units, suffix


def _layer_order(cfg: ArchConfig, layout_scan: bool) -> List[int]:
    """The layers in the order ``forward`` runs them: ``scan_plan``'s
    prefix, units and suffix under ``layout_scan``.  Eager PyTorch has no
    compile time to save, so the scan is the unrolled loop in the same
    order over the same (unstacked) params: the same computation."""
    if not layout_scan:
        return list(range(cfg.n_layers))
    prefix, unit, n_units, suffix = scan_plan(cfg)
    start = len(prefix)
    body = [start + u * unit + pos for u in range(n_units) for pos in range(unit)]
    return prefix + body + suffix


_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy: keep the outputs of 2-D matmuls (every
    ``linear``), recompute the rest -- batched products (attention scores,
    expert stacks) included, as ``dots_with_no_batch_dims_saveable``."""
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def checkpointed(fn, policy: str = "full"):
    """``fn`` under activation checkpointing (non-reentrant, so
    ``torch.autograd.grad`` works through it): its activations are
    recomputed in the backward; ``policy="dots"`` keeps the 2-D matmul
    outputs (:func:`_save_dots`)."""
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(ckpt.create_selective_checkpoint_contexts,
                                             _save_dots)

    def on_mesh(*args):  # the recompute runs in the backward, outside forward
        with mesh_context(args):
            return fn(*args)

    def run(*args):
        return ckpt.checkpoint(on_mesh, *args, use_reentrant=False, **kw)

    return run


def _attn_kind(cfg: ArchConfig) -> str:
    return "mla" if cfg.kv_lora_rank else "gqa"


def _is_moe_layer(cfg: ArchConfig, i: int) -> bool:
    return cfg.moe is not None and i >= cfg.moe.first_dense


def _window(cfg: ArchConfig, kind: str) -> Optional[int]:
    return cfg.recurrent.window if (kind == "localattn" and cfg.recurrent) else None


def init_layer(gen: torch.Generator, cfg: ArchConfig, i: int, dtype=torch.bfloat16) -> Params:
    kind = block_kinds(cfg)[i]
    dev = gen.device
    p: Params = {"norm1": init_rmsnorm(cfg.d_model, dtype, dev)}
    if kind == "mamba":
        p["mixer"] = ssm_mod.init_mamba2(gen, cfg, dtype)
        return p
    if kind == "rec":
        p["mixer"] = rglru_mod.init_rglru_block(gen, cfg, dtype)
    elif _attn_kind(cfg) == "mla":
        p["attn"] = attn_mod.init_mla(gen, cfg, dtype)
    else:
        p["attn"] = attn_mod.init_gqa(gen, cfg, dtype)
    p["norm2"] = init_rmsnorm(cfg.d_model, dtype, dev)
    if kind in ("attn", "localattn") and _is_moe_layer(cfg, i):
        p["moe"] = ffn_mod.init_moe(gen, cfg, dtype)
    else:
        # paper recipe: column-prune the FFN
        prune = ("colpack_xla", cfg.prune.sparsity) if cfg.prune.enabled else None
        p["ffn"] = ffn_mod.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, prune=prune)
    return p


def init_lm(gen: torch.Generator, cfg: ArchConfig) -> Params:
    dtype = model_dtype(cfg)
    p: Params = {
        "embed": init_embedding(gen, cfg.vocab_padded, cfg.d_model, dtype),
        "layers": [init_layer(gen, cfg, i, dtype) for i in range(cfg.n_layers)],
        "final_norm": init_rmsnorm(cfg.d_model, dtype, gen.device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = init_linear(gen, cfg.d_model, cfg.vocab_padded, dtype=dtype)
    if cfg.vision_tokens:
        p["vision_proj"] = init_linear(gen, cfg.d_model, cfg.d_model, dtype=dtype)
    return p


def _embed_inputs(params: Params, tokens: torch.Tensor, patch_embeds):
    """Token embeddings, with the projected patch embeddings prepended (a
    VLM); returns ``(x, positions [B, S], prefix_len)``."""
    x = embed(params["embed"], tokens)
    prefix_len = 0
    if patch_embeds is not None:
        vis = linear(params["vision_proj"], patch_embeds)
        x = torch.cat([vis.to(x.dtype), x], dim=1)
        prefix_len = patch_embeds.shape[1]
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    return x, positions, prefix_len


def _ffn(p: Params, cfg: ArchConfig, x: torch.Tensor, mode: str):
    """The block's second half (norm2 + MLP or MoE): ``(x + y, aux)``."""
    h2 = rmsnorm(p["norm2"], x, cfg.norm_eps)
    if "moe" in p:
        y, aux = ffn_mod.moe(p["moe"], cfg, h2, activation=cfg.ffn_activation)
        return x + y, aux
    return x + ffn_mod.mlp(p["ffn"], h2, activation=cfg.ffn_activation, mode=mode), None


def _apply_block(p: Params, cfg: ArchConfig, kind: str, x: torch.Tensor,
                 positions: torch.Tensor, *, prefix_len: int = 0, attn_impl: str = "auto",
                 mode: str = "dense", attn_chunk: int = 1024
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Returns ``(x_out, aux_loss or None)``."""
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    # the recurrent mixers are tensor-parallel: on a mesh each rank runs them
    # on its batch rows and its share of the heads or channels
    if kind == "mamba":
        return x + on_mixer(lambda pm, hh, cut: ssm_mod.mamba2_forward(pm, cfg, hh, cut=cut),
                            h, p["mixer"], **ssm_mod.TP), None
    if kind == "rec":
        mixed = on_mixer(lambda pm, hh, cut: rglru_mod.rglru_block(pm, cfg, hh, cut=cut),
                         h, p["mixer"], **rglru_mod.TP)
    elif _attn_kind(cfg) == "mla":
        mixed = attn_mod.mla_attention(p["attn"], cfg, h, positions, impl=attn_impl)
    else:
        mixed = attn_mod.gqa_attention(p["attn"], cfg, h, positions, window=_window(cfg, kind),
                                       prefix_len=prefix_len, impl=attn_impl, mode=mode,
                                       chunk=attn_chunk)
    return _ffn(p, cfg, x + mixed, mode)


def forward(
    params: Params,
    cfg: ArchConfig,
    tokens: torch.Tensor,
    *,
    patch_embeds: Optional[torch.Tensor] = None,
    attn_impl: str = "auto",
    mode: str = "dense",
    remat: bool = False,
    layout_scan: bool = False,
    remat_policy: str = "full",
    residual_spec=None,
    attn_chunk: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(logits [B, S_text, V_pad], aux_loss)``; pad classes are
    ``-1e30``, aux is the MoE layers' summed router loss (0 without MoE).

    ``remat=True`` checkpoints each block (:func:`checkpointed` with
    ``remat_policy``), the memory / compute trade of full-width training;
    ``layout_scan=True`` runs ``scan_plan``'s groups in order, the unrolled
    loop's computation (:func:`_layer_order`); ``residual_spec`` (a
    ``sharding.PartitionSpec``) redistributes the residual stream after
    every block when it is a DTensor, JAX's ``with_sharding_constraint``
    (e.g. sequence parallelism: ``P("data", "model", None)``).

    DTensor params and inputs (``sharding.distribute_params``) run the same
    code on a mesh: the constants it builds count as replicated
    (``sharding.mesh_context``).  On plain tensors nothing changes."""
    with mesh_context(tokens, params):
        x, positions, prefix_len = _embed_inputs(params, tokens, patch_embeds)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        kinds = block_kinds(cfg)
        for i in _layer_order(cfg, layout_scan):
            blk = functools.partial(_constrained_block, params["layers"][i], cfg, kinds[i],
                                    positions=positions, prefix_len=prefix_len,
                                    attn_impl=attn_impl, mode=mode, attn_chunk=attn_chunk,
                                    residual_spec=residual_spec)
            x, aux = (checkpointed(blk, remat_policy) if remat else blk)(x)
            if aux is not None:
                aux_total = aux_total + aux
        if residual_spec is not None:
            x = replicate_axis(x, 1)
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return _unembed(params, cfg, x[:, prefix_len:]), aux_total


def _constrained_block(p: Params, cfg: ArchConfig, kind: str, x: torch.Tensor, *,
                       residual_spec=None, **kw):
    """A block under ``residual_spec``: the residual stream is kept as the
    spec says between blocks; a block runs on whole sequences (sequence
    parallelism gathers the sequence at a block's entry)."""
    if residual_spec is not None:
        x = replicate_axis(x, 1)
    out, aux = _apply_block(p, cfg, kind, x, **kw)
    return constrain(out, residual_spec), aux


def _unembed(params: Params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """The logits; on a mesh split over the vocab as the head's weight is,
    whatever the padding (``sharding.head_operands``)."""
    if cfg.tie_embeddings:
        x, table = head_operands(x, params["embed"]["table"], 0)
        logits = x @ table.T
    else:
        x, w = head_operands(x, params["lm_head"]["w"], 1)
        logits = linear({**params["lm_head"], "w": w}, x)
    if cfg.vocab_padded != cfg.vocab:  # mask pad classes (never predicted)
        pad = torch.arange(cfg.vocab_padded, device=x.device) < cfg.vocab
        logits = torch.where(pad, logits, torch.full((), -1e30, dtype=logits.dtype,
                                                     device=x.device))
    return logits


def loss_fn(
    params: Params,
    cfg: ArchConfig,
    batch: Dict[str, torch.Tensor],
    *,
    attn_impl: str = "auto",
    mode: str = "dense",
    remat: bool = False,
    layout_scan: bool = False,
    remat_policy: str = "full",
    residual_spec=None,
    attn_chunk: int = 1024,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy over ``batch["tokens"]`` / ``batch["labels"]``
    (``[B, S]`` ints; ``batch["patch_embeds"]`` for a VLM), weighted by
    ``batch["weights"]`` when given, plus ``router_aux_weight x aux`` for
    MoE; returns ``(total, {"ce", "aux"})``.

    The memory knobs (``remat``, ``remat_policy``, ``layout_scan``,
    ``attn_chunk``) and ``residual_spec`` go to :func:`forward`, as in JAX.
    ``attn_impl`` is ``sdpa``'s: "auto" is full attention up to 8192 keys
    and chunked beyond, as in JAX."""
    logits, aux = forward(params, cfg, batch["tokens"], patch_embeds=batch.get("patch_embeds"),
                          attn_impl=attn_impl, mode=mode, remat=remat,
                          layout_scan=layout_scan, remat_policy=remat_policy,
                          residual_spec=residual_spec, attn_chunk=attn_chunk)
    with mesh_context(logits):
        labels = batch["labels"].long()
        # CE via logsumexp: one f32 reduction instead of a full log_softmax
        # copy (vocab-parallel on vocab-sharded logits)
        lse, picked = logsumexp_pick(logits.float(), labels)
        nll = lse - picked
        weights = batch.get("weights")
        if weights is None:
            weights = torch.ones_like(nll)
        ce = torch.sum(nll * weights) / torch.clamp(torch.sum(weights), min=1.0)
        aux_w = cfg.moe.router_aux_weight if cfg.moe else 0.0
        return ce + aux_w * aux, {"ce": ce, "aux": aux}


# --------------------------------------------------------------------------- #
# serving: prefill (forward + populated caches), empty caches, one decode step #
# --------------------------------------------------------------------------- #


def prefill(
    params: Params, cfg: ArchConfig, tokens: torch.Tensor, max_len: int, *,
    patch_embeds: Optional[torch.Tensor] = None, attn_impl: str = "auto",
) -> Tuple[torch.Tensor, List[Params]]:
    """Returns ``(logits [B, S_text, V_pad], caches)``: one cache a layer,
    every row positioned after the prefix and the text.

    DTensor params and batch-cut ``tokens`` / ``patch_embeds`` run the same
    code on a mesh, as :func:`forward` does: the recurrent mixers run on
    each rank's rows and heads or channels (``sharding.on_mixer``), each
    attention cache is filled on each rank's rows and heads and then cut
    over its slots, and every cache leaf comes back in the placements its
    decode steps take (``sharding.cache_pspecs``: batch over the data axes;
    the KV / MLA sequence, the Mamba-2 heads and the RG-LRU and conv
    channels over ``model``; ``pos`` over the batch), so the first step
    moves nothing.  The logits come back split over the batch and the
    vocab.  On plain tensors nothing changes."""
    with mesh_context(tokens, params, patch_embeds):
        x, positions, prefix_len = _embed_inputs(params, tokens, patch_embeds)
        b = x.shape[0]
        caches: List[Params] = []
        for p, kind in zip(params["layers"], block_kinds(cfg)):
            h = rmsnorm(p["norm1"], x, cfg.norm_eps)
            if kind == "mamba":
                mixed, cache = on_mixer(
                    lambda pm, hh, cut: ssm_mod.mamba2_forward(pm, cfg, hh, return_state=True,
                                                               cut=cut),
                    h, p["mixer"], state=ssm_mod.init_mamba2_cache(cfg, b, device="meta"),
                    **ssm_mod.TP)
                x = x + mixed
            else:
                if kind == "rec":
                    mixed, cache = on_mixer(
                        lambda pm, hh, cut: rglru_mod.rglru_block(pm, cfg, hh, return_state=True,
                                                                  cut=cut),
                        h, p["mixer"], state=rglru_mod.init_rglru_cache(cfg, b, device="meta"),
                        **rglru_mod.TP)
                elif _attn_kind(cfg) == "mla":
                    mixed, cache = attn_mod.mla_prefill(p["attn"], cfg, h, positions, max_len,
                                                        impl=attn_impl)
                else:
                    mixed, cache = attn_mod.gqa_prefill(
                        p["attn"], cfg, h, positions, max_len, window=_window(cfg, kind),
                        prefix_len=prefix_len, impl=attn_impl)
                x, _ = _ffn(p, cfg, x + mixed, "dense")
            caches.append(place_cache(cache))
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return _unembed(params, cfg, x[:, prefix_len:]), caches


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> List[Params]:
    """Empty per-layer caches, each of its block's kind."""
    caches: List[Params] = []
    for kind in block_kinds(cfg):
        if kind == "mamba":
            caches.append(ssm_mod.init_mamba2_cache(cfg, batch, dtype, device=device))
        elif kind == "rec":
            caches.append(rglru_mod.init_rglru_cache(cfg, batch, dtype, device=device))
        elif _attn_kind(cfg) == "mla":
            caches.append(attn_mod.init_mla_cache(cfg, batch, max_len, dtype, device=device))
        else:
            caches.append(attn_mod.init_kv_cache(cfg, batch, max_len, window=_window(cfg, kind),
                                                 dtype=dtype, device=device))
    return caches


def decode_step(
    params: Params,
    cfg: ArchConfig,
    tokens_t: torch.Tensor,  # [B, 1] int
    caches: List[Params],
    *,
    mode: str = "dense",
) -> Tuple[torch.Tensor, List[Params]]:
    """One token for the whole stack.  Returns ``(logits [B, 1, V_pad],
    caches)``: new cache tensors, the inputs are not modified.  On a mesh
    (DTensor params, ``tokens_t`` and caches; the constants it builds count
    as replicated) every cache tensor comes back in the placements it came
    in."""
    with mesh_context(tokens_t, params, caches):
        x = embed(params["embed"], tokens_t)
        new_caches: List[Params] = []
        for p, kind, cache in zip(params["layers"], block_kinds(cfg), caches):
            h = rmsnorm(p["norm1"], x, cfg.norm_eps)
            # on a mesh the recurrent steps run on each rank's batch rows and
            # its heads or channels, with the state and conv window where they lie
            if kind == "mamba":
                mixed, cache = on_mixer(
                    lambda pm, hh, c, cut: ssm_mod.mamba2_step(pm, cfg, hh, c, cut),
                    h, p["mixer"], cache, **ssm_mod.TP)
                x = x + mixed
            else:
                if kind == "rec":
                    mixed, cache = on_mixer(
                        lambda pm, hh, c, cut: rglru_mod.rglru_step(pm, cfg, hh, c, cut),
                        h, p["mixer"], cache, **rglru_mod.TP)
                elif _attn_kind(cfg) == "mla":
                    mixed, cache = attn_mod.mla_decode_step(p["attn"], cfg, h, cache)
                else:
                    mixed, cache = attn_mod.gqa_decode_step(
                        p["attn"], cfg, h, cache, window=_window(cfg, kind), mode=mode)
                x, _ = _ffn(p, cfg, x + mixed, mode)
            new_caches.append(cache)
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return _unembed(params, cfg, x), new_caches
