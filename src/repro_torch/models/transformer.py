"""Model assembly: embeddings -> layer stack -> head, for all families.

The port of ``src/repro/models/transformer.py``. Homogeneous stacks
(dense / moe / mla / hybrid / encoder / vlm) store layer parameters with a
leading ``layers`` axis; in training each unit of ``cfg.remat_block``
layers runs under ``torch.utils.checkpoint``, as each runs under
``jax.checkpoint`` in the reference, so only a unit's input is saved for
backward. xLSTM stacks are heterogeneous (alternating mLSTM/sLSTM): a
``blocks`` list, one checkpointed block at a time.

``forward(cfg, params, batch, mode, cache, cache_len_total)``, a plain
function on the tensor tree as the reference's is:
  mode="train"   -> (loss, metrics)
  mode="encode"  -> (per-position logits, None)
  mode="prefill" -> (last-position logits, cache)   [batch["last_pos"]: ragged]
  mode="decode"  -> (logits, new_cache)   [batch["pos"]: scalar or (B,)]
Only training checkpoints its units; the serve modes run each layer once.
``TransformerLM`` registers the same leaves as ``nn.Parameter``s for
optimizers and ``state_dict``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import ModelConfig
from repro_torch.dist import collectives
from repro_torch.dist.collectives import act_gather
from repro_torch.dist.sharding import constrain, is_dtensor, remat_contexts
from repro_torch.models import attention, moe, ssm, xlstm
from repro_torch.models.common import (
    Spec, TensorSpec, as_positions, einsum, repeated, resolve_device,
    rms_norm, softmax_xent, stack_layer_specs, swiglu, tree_abstract, tree_axes,
    tree_init, tree_map,
)

VIT_HIDDEN = 1024    # stub InternViT output dim
AUDIO_HIDDEN = 512   # stub conv-frontend output dim

SCANNED_FAMILIES = ("dense", "moe", "mla", "hybrid", "encoder_audio", "vlm")

MOE_AUX = ("moe_lb_loss", "moe_z_loss", "moe_drop_frac")


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

def layer_specs(cfg: ModelConfig) -> Dict[str, Any]:
    s: Dict[str, Any] = {"ln1": Spec((cfg.d_model,), ("embed",), init="ones"),
                         "ln2": Spec((cfg.d_model,), ("embed",), init="ones")}
    if cfg.family == "mla":
        s["attn"] = attention.mla_specs(cfg)
    else:
        s["attn"] = attention.gqa_specs(cfg)
    if cfg.family == "hybrid":
        s["ssm"] = ssm.ssm_specs(cfg)
    if cfg.family == "moe":
        s["moe"] = moe.moe_specs(cfg)
    elif cfg.d_ff > 0:
        s["mlp"] = {
            "gate": Spec((cfg.d_model, cfg.d_ff), ("embed", "mlp")),
            "up": Spec((cfg.d_model, cfg.d_ff), ("embed", "mlp")),
            "down": Spec((cfg.d_ff, cfg.d_model), ("mlp", "embed")),
        }
    return s


def param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    d, v = cfg.d_model, cfg.vocab
    specs: Dict[str, Any] = {
        "embed": Spec((v, d), ("vocab" if cfg.tie_embeddings else "vocab_in",
                               "embed")),
        "final_norm": Spec((d,), ("embed",), init="ones"),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = Spec((d, v), ("embed", "vocab"))
    if cfg.frontend == "vit_patches":
        specs["vision_adapter"] = Spec((VIT_HIDDEN, d), (None, "embed"))
    if cfg.frontend == "audio_frames":
        specs["audio_adapter"] = Spec((AUDIO_HIDDEN, d), (None, "embed"))
    if cfg.family == "ssm_xlstm":
        specs["blocks"] = [
            xlstm.mlstm_specs(cfg) if xlstm.is_mlstm_layer(cfg, i)
            else xlstm.slstm_specs(cfg)
            for i in range(cfg.n_layers)]
    else:
        specs["layers"] = stack_layer_specs(layer_specs(cfg), cfg.n_layers)
    return specs


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

# Cache leaves that carry attention KV state: the leaves a quantized
# resident cache stores compressed (kv_storage="int8": s8 values + f32
# scales along the trailing feature axis; "f8": scale-free e4m3).
# Recurrent-state leaves (ssm_*, xlstm blocks) are never quantized.
QUANTIZABLE_CACHE_KEYS = ("k", "v", "latent", "k_rope")


def is_tensor_spec(x) -> bool:
    return isinstance(x, TensorSpec)


def is_axes(x) -> bool:
    """A leaf of an axes tree: a tuple of logical axis names."""
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def cache_struct(cfg: ModelConfig, batch: int, seq: int,
                 kv_storage: str = "bf16") -> Dict[str, Any]:
    """Shapes (python ints) for the decode cache; no allocation.

    ``kv_storage="int8"`` adds a ``<leaf>_scale`` entry per attention leaf
    (the leaf's shape with the trailing feature dim replaced by its
    per-position block count); ``"f8"`` keeps the bf16 shapes."""
    if kv_storage not in collectives.KV_STORAGES:
        raise ValueError(f"unknown kv_storage {kv_storage!r}; "
                         f"expected one of {collectives.KV_STORAGES}")
    if cfg.family == "ssm_xlstm":
        return {"blocks": [
            (xlstm.mlstm_cache_shape(cfg, batch)
             if xlstm.is_mlstm_layer(cfg, i)
             else xlstm.slstm_cache_shape(cfg, batch))
            for i in range(cfg.n_layers)]}
    if cfg.family == "mla":
        per = attention.mla_cache_shape(cfg, batch, seq)
    else:
        per = attention.gqa_cache_shape(cfg, batch, seq)
    out = {k: (cfg.n_layers,) + v for k, v in per.items()}
    if cfg.family == "hybrid":
        for k, v in ssm.ssm_cache_shape(cfg, batch).items():
            out["ssm_" + k] = (cfg.n_layers,) + v
    if kv_storage == "int8":
        for k in [k for k in out if k in QUANTIZABLE_CACHE_KEYS]:
            shape = out[k]
            _, nb = collectives.lastdim_blocks(shape[-1])
            out[k + "_scale"] = shape[:-1] + (nb,)
    return out


def _flat_cache_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """The flat cache's leaf axes from the family modules' layouts: the
    stack prepends "layers", and each scale leaf is its value leaf's
    layout with the trailing block axis unsharded."""
    if cfg.family == "mla":
        per = attention.mla_cache_axes()
    else:
        per = attention.gqa_cache_axes()
    out = {k: ("layers",) + v for k, v in per.items()}
    if cfg.family == "hybrid":
        for k, v in ssm.ssm_cache_axes().items():
            out["ssm_" + k] = ("layers",) + v
    for k in QUANTIZABLE_CACHE_KEYS:
        if k in out:
            out[k + "_scale"] = out[k][:-1] + (None,)
    return out


def cache_axes(cfg: ModelConfig, batch: int, seq: int,
               kv_storage: str = "bf16") -> Dict[str, Any]:
    struct = cache_struct(cfg, batch, seq, kv_storage)
    if cfg.family == "ssm_xlstm":
        return {"blocks": [
            {k: ("batch",) + (None,) * (len(v) - 1) for k, v in blk.items()}
            for blk in struct["blocks"]]}
    axes = _flat_cache_axes(cfg)
    return {k: axes[k] for k in struct}


def _cache_leaf_dtype(name: Optional[str], kv_storage: str, dtype):
    if kv_storage == "bf16" or name is None:
        return dtype
    if name.endswith("_scale"):
        return torch.float32
    if name in QUANTIZABLE_CACHE_KEYS:
        return torch.int8 if kv_storage == "int8" else collectives.F8_DTYPE
    return dtype


def abstract_cache(cfg: ModelConfig, batch: int, seq: int,
                   dtype=torch.bfloat16, kv_storage: str = "bf16"
                   ) -> Dict[str, Any]:
    """The cache's ``TensorSpec``s, in its resident layout."""
    def mk(shape, name=None):
        return TensorSpec(tuple(shape),
                          _cache_leaf_dtype(name, kv_storage, dtype))
    struct = cache_struct(cfg, batch, seq, kv_storage)
    if cfg.family == "ssm_xlstm":
        return {"blocks": [{k: mk(v) for k, v in blk.items()}
                           for blk in struct["blocks"]]}
    return {k: mk(v, k) for k, v in struct.items()}


def zeros_like_spec(tree, device) -> Any:
    """Zeros of each ``TensorSpec`` in ``tree``, on ``device``."""
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                          device=device),
                    tree, is_leaf=is_tensor_spec)


def init_cache(cfg: ModelConfig, batch: int, seq: int, dtype=torch.bfloat16,
               kv_storage: str = "bf16", *,
               device: Union[str, torch.device, None] = None):
    """A zero cache, on the card unless ``device`` names another."""
    return zeros_like_spec(abstract_cache(cfg, batch, seq, dtype, kv_storage),
                           resolve_device(device, "init_cache"))


def quantize_cache_int8(cache: Dict[str, Any]) -> Dict[str, Any]:
    """A bf16 decode cache in the int8-resident layout: every attention
    leaf becomes s8 values + a ``<leaf>_scale`` f32 leaf, quantized
    blockwise along the trailing feature axis (per position, as the
    decode step writes each new token). Recurrent leaves pass through."""
    out: Dict[str, Any] = {}
    for name, leaf in cache.items():
        if name in QUANTIZABLE_CACHE_KEYS:
            q, s = collectives.quantize_int8_lastdim(leaf)
            out[name] = q
            out[name + "_scale"] = s
        else:
            out[name] = leaf
    return out


def quantize_cache(cache: Dict[str, Any], kv_storage: str) -> Dict[str, Any]:
    """A bf16 decode cache (or cache slice) in the resident layout for
    ``kv_storage``: the identity for "bf16", s8 + scales for "int8",
    scale-free e4m3 for "f8"."""
    if kv_storage == "bf16":
        return cache
    if kv_storage == "int8":
        return quantize_cache_int8(cache)
    if kv_storage == "f8":
        return {name: collectives.cast_f8(leaf)
                if name in QUANTIZABLE_CACHE_KEYS else leaf
                for name, leaf in cache.items()}
    raise ValueError(f"unknown kv_storage {kv_storage!r}; "
                     f"expected one of {collectives.KV_STORAGES}")


# ---------------------------------------------------------------------------
# layer body (stacked families)
# ---------------------------------------------------------------------------

@repeated
def _layer_body(cfg: ModelConfig, mode: str, cache_len_total: int,
                x, lp, lcache, pos):
    aux = {}
    # residual stream anchor; under the "sp"/"serve_sp" presets seq_res ->
    # model shards the residual stream (Megatron sequence parallelism)
    x = constrain(x, "batch", "seq_res", "act_embed")
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    if mode != "decode":
        # the sp activation all-gather: attention needs the full sequence
        # (int8 on the wire under act_transport="int8"); decode's gather
        # is the KV-cache gather inside the attention layer instead
        h = act_gather(h, "batch", None, "act_embed")
    attn_cache = None
    if lcache is not None and cfg.family != "hybrid":
        attn_cache = lcache
    elif lcache is not None:
        attn_cache = {"k": lcache["k"], "v": lcache["v"]}
    if cfg.family == "mla":
        attn_out, new_attn = attention.mla_apply(
            cfg, lp["attn"], h, mode, attn_cache, pos, cache_len_total)
    else:
        attn_out, new_attn = attention.gqa_apply(
            cfg, lp["attn"], h, mode, attn_cache, pos, cache_len_total)
    if cfg.family == "hybrid":
        ssm_cache = None
        if lcache is not None:
            ssm_cache = {"conv": lcache["ssm_conv"], "ssm": lcache["ssm_ssm"]}
        ssm_out, new_ssm = ssm.ssm_apply(cfg, lp["ssm"], h, mode, ssm_cache)
        x = x + 0.5 * (attn_out + ssm_out)
    else:
        x = x + attn_out
    h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
    if mode != "decode":
        h2 = act_gather(h2, "batch", None, "act_embed")   # sp gather, MLP side
    if cfg.family == "moe":
        y, aux = moe.moe_apply(cfg, lp["moe"], h2, mode=mode)
    elif cfg.d_ff > 0:
        y = swiglu(h2, lp["mlp"]["gate"], lp["mlp"]["up"], lp["mlp"]["down"])
    else:
        y = torch.zeros_like(x)
    x = x + y

    new_cache = None
    if new_attn is not None:
        new_cache = dict(new_attn)
        if cfg.family == "hybrid":
            new_cache = {"k": new_attn["k"], "v": new_attn["v"],
                         "ssm_conv": new_ssm["conv"], "ssm_ssm": new_ssm["ssm"]}
    return x, new_cache, aux


def _run_stack(cfg, params, x, mode, cache=None, pos=0, cache_len_total=0):
    """Run the stacked layers. Returns (x, new_cache, aux).

    Training: ``cfg.remat_block`` layers form one rematerialization unit
    under ``torch.utils.checkpoint``, so only the unit's input is saved
    for backward and the unit runs forward again in backward. The serve
    modes run each layer once, layer ``l`` reading ``cache[leaf][l]``;
    prefill and decode stack the layers' new caches along a leading
    ``layers`` axis.
    """
    rb = max(1, cfg.remat_block)
    n_units = cfg.n_layers // rb
    assert cfg.n_layers % rb == 0, (cfg.n_layers, rb)
    layers = params["layers"]
    has_cache = cache is not None and mode == "decode"

    def layer(i, xcur):
        lp = tree_map(lambda t: t[i], layers)
        lcache = {k: v[i] for k, v in cache.items()} if has_cache else None
        return _layer_body(cfg, mode, cache_len_total, xcur, lp, lcache, pos)

    def unit_body(xcur, u):
        aux_tot = {}
        for j in range(rb):
            xcur, _, aux = layer(u * rb + j, xcur)
            for k, v in aux.items():
                aux_tot[k] = aux_tot.get(k, 0.0) + v
        return xcur, aux_tot

    aux_acc = {}
    if cfg.family == "moe":
        aux_acc = {k: torch.zeros((), dtype=torch.float32, device=x.device)
                   for k in MOE_AUX}
    new_cache = None
    if mode == "train":
        for u in range(n_units):
            x, aux = checkpoint(unit_body, x, u, use_reentrant=False,
                                context_fn=remat_contexts)
            aux_acc = {k: aux_acc[k] + aux[k] for k in aux_acc}
    else:
        caches = []
        for i in range(cfg.n_layers):
            x, lc, aux = layer(i, x)
            caches.append(lc)
            aux_acc = {k: aux_acc[k] + aux[k] for k in aux_acc}
        if mode in ("decode", "prefill") and caches[0] is not None:
            new_cache = {k: torch.stack([c[k] for c in caches])
                         for k in caches[0]}
    if cfg.family == "moe":
        aux_acc = {k: v / cfg.n_layers for k, v in aux_acc.items()}
    return x, new_cache, aux_acc


def _run_xlstm(cfg, params, x, mode, cache=None):
    new_blocks = []
    blocks_cache = cache["blocks"] if cache is not None else [None] * cfg.n_layers
    for i, bp in enumerate(params["blocks"]):
        fn = xlstm.mlstm_apply if xlstm.is_mlstm_layer(cfg, i) else xlstm.slstm_apply
        if mode == "train":
            x, bc = checkpoint(fn, cfg, bp, x, mode, None, use_reentrant=False,
                               context_fn=remat_contexts)
        else:
            x, bc = fn(cfg, bp, x, mode, blocks_cache[i])
        new_blocks.append(bc)
    if mode in ("decode", "prefill"):
        return x, {"blocks": new_blocks}, {}
    return x, None, {}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _embed_inputs(cfg, params, batch, mode):
    if cfg.frontend == "audio_frames":
        return constrain(einsum("bsf,fd->bsd", batch["frames"],
                                params["audio_adapter"]),
                         "batch", None, "act_embed")
    tok = _embed(params["embed"], batch["tokens"].long())
    tok = constrain(tok, "batch", None, "act_embed")
    if cfg.frontend == "vit_patches" and mode != "decode":
        vis = einsum("bpf,fd->bpd", batch["patches"],
                     params["vision_adapter"])
        return constrain(torch.cat([vis, tok], dim=1),
                         "batch", None, "act_embed")
    return tok


def _embed(table, ids):
    """``table[ids]``. A DTensor table is read shard by shard: its vocab
    dim gathered whole and the ids gathered whole, each rank takes every
    id's row of its own columns, laid out by those columns (the rows
    whole) -- a plain index whose backward is local to the rank, where
    DTensor's own index backward cannot lay out a table split over two
    mesh dims on torch 2.11."""
    if not is_dtensor(table):
        return table[ids]
    from torch.distributed.tensor import Replicate, Shard

    whole = collectives.redistribute("reshard", table, collectives.without_dims(
        table.placements, (0,), table.ndim))
    if is_dtensor(ids):
        ids = ids.full_tensor()               # integers, no gradient
    place = tuple(Shard(ids.ndim) if p.is_shard() else Replicate()
                  for p in whole.placements)
    return collectives.from_local(whole.to_local()[ids], whole, place,
                                  shape=tuple(ids.shape) + (table.shape[1],))


def _logits(cfg, params, x):
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    out = einsum("...d,dv->...v", x, head)
    return constrain(out, *(("batch",) + (None,) * (out.ndim - 2) + ("vocab",)))


def forward(cfg: ModelConfig, params, batch: Dict[str, Any],
            mode: str = "train", cache=None, cache_len_total: int = 0):
    """``mode="train"`` -> (loss, metrics) with the reference's metric
    names: ``ce_loss`` and ``loss``, and for MoE the three aux terms
    averaged over layers, which enter the loss with weights 0.01 (load
    balance) and ``cfg.router_aux_weight`` (z-loss). ``"encode"`` ->
    (per-position logits, None); ``"prefill"`` -> (last-position logits,
    cache), the last position per row from ``batch["last_pos"]`` when
    given; ``"decode"`` -> (logits, new cache) at ``batch["pos"]``, a
    scalar or per-row (B,). Runs where the tensors are."""
    if mode not in ("train", "encode", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    x = _embed_inputs(cfg, params, batch, mode)
    pos = batch.get("pos", 0)
    if cfg.family == "ssm_xlstm":
        x, new_cache, aux = _run_xlstm(cfg, params, x, mode, cache)
    else:
        x, new_cache, aux = _run_stack(cfg, params, x, mode, cache, pos,
                                       cache_len_total)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)

    if mode == "train":
        if cfg.frontend == "vit_patches":
            x = x[:, cfg.n_vision_tokens:]       # loss on text positions only
        logits = _logits(cfg, params, x)
        loss = softmax_xent(logits, batch["labels"], batch.get("mask"))
        metrics = {"ce_loss": loss}
        if cfg.family == "moe":
            loss = loss + 0.01 * aux["moe_lb_loss"] \
                + cfg.router_aux_weight * aux["moe_z_loss"]
            metrics.update(aux)
        metrics["loss"] = loss
        return loss, metrics

    if mode == "encode":  # encoder-only serving: per-position unit logits
        return _logits(cfg, params, x), None

    if mode == "prefill":
        last = batch.get("last_pos")
        if last is None:
            xl = x[:, -1]
        else:   # ragged prompts: per-row index of the final prompt token
            idx = as_positions(last, x.device).long()
            xl = x[torch.arange(x.shape[0], device=x.device), idx]
        return _logits(cfg, params, xl), new_cache

    # decode
    return _logits(cfg, params, x[:, -1]), new_cache


# ---------------------------------------------------------------------------
# public param API
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, *, seed: int,
                device: Union[str, torch.device, None] = None,
                draw_on_device: bool = False):
    """A parameter tree of ``param_specs(cfg)``'s shapes and dtypes, drawn
    from ``seed``; on the card unless ``device`` names another. The draws
    come from the host, the same on every device, unless
    ``draw_on_device``: then a generator on ``device`` draws them, which
    takes a second where the host takes a minute for an 8B model, but
    gives other values."""
    return tree_init(param_specs(cfg), seed,
                     resolve_device(device, "init_params"), draw_on_device)


def abstract_params(cfg: ModelConfig):
    """The parameter tree's ``TensorSpec``s: shapes and dtypes, no data."""
    return tree_abstract(param_specs(cfg))


def param_axes(cfg: ModelConfig):
    """The parameter tree's logical axes, a tuple of names per leaf."""
    return tree_axes(param_specs(cfg))


def _module_of(tree) -> nn.Module:
    if isinstance(tree, list):
        return nn.ModuleList([_module_of(t) for t in tree])
    mod = nn.Module()
    _register(mod, tree)
    return mod


def _register(mod: nn.Module, tree: Dict[str, Any]) -> None:
    for k, v in tree.items():
        if isinstance(v, torch.Tensor):
            mod.register_parameter(k, nn.Parameter(v))
        else:
            mod.add_module(k, _module_of(v))


def _tree_of(mod: nn.Module, layout):
    if isinstance(layout, list):
        return [_tree_of(m, t) for m, t in zip(mod, layout)]
    return {k: getattr(mod, k) if v is None else _tree_of(getattr(mod, k), v)
            for k, v in layout.items()}


class TransformerLM(nn.Module):
    """The parameter tree as a module: each leaf an ``nn.Parameter`` under
    its tree path (``layers.attn.wq``, ``blocks.1.r_gates``), stacked as in
    the tree. ``params()`` gives the tree back for ``forward``.

    ``params``: a tree to adopt (for example from ``params_from_jax``);
    otherwise ``init_params(cfg, seed=seed, device=device)``.
    """

    def __init__(self, cfg: ModelConfig, *, seed: int = 0,
                 device: Union[str, torch.device, None] = None,
                 params: Optional[Dict[str, Any]] = None) -> None:
        super().__init__()
        self.cfg = cfg
        if params is None:
            params = init_params(cfg, seed=seed, device=device)
        self._layout = tree_map(lambda t: None, params)
        _register(self, params)

    def params(self) -> Dict[str, Any]:
        return _tree_of(self, self._layout)

    def forward(self, batch: Dict[str, Any], mode: str = "train",
                cache=None, cache_len_total: int = 0):
        return forward(self.cfg, self.params(), batch, mode, cache,
                       cache_len_total)
