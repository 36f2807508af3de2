"""Model assembly: embeddings -> layer stack -> head, for all families.

The port of ``src/repro/models/transformer.py``, training path.
Homogeneous stacks (dense / moe / mla / hybrid / encoder / vlm) store layer
parameters with a leading ``layers`` axis; each unit of ``cfg.remat_block``
layers runs under ``torch.utils.checkpoint``, as each runs under
``jax.checkpoint`` in the reference, so only a unit's input is saved for
backward. xLSTM stacks are heterogeneous (alternating mLSTM/sLSTM): a
``blocks`` list, one checkpointed block at a time.

``forward(cfg, params, batch, mode="train")`` -> (loss, metrics), a plain
function on the tensor tree as the reference's is. Prefill, decode and
encode come with serving (ROADMAP queue 1, item 2).
``TransformerLM`` registers the same leaves as ``nn.Parameter``s for
optimizers and ``state_dict``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import ModelConfig
from repro_torch.dist.collectives import act_gather
from repro_torch.dist.sharding import constrain
from repro_torch.models import attention, moe, ssm, xlstm
from repro_torch.models.common import (
    Spec, einsum, require_train, resolve_device, rms_norm, softmax_xent,
    stack_layer_specs, swiglu, tree_init, tree_map,
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
# layer body (stacked families)
# ---------------------------------------------------------------------------

def _layer_body(cfg: ModelConfig, mode: str, x, lp):
    aux = {}
    # residual stream anchor; under the "sp" preset seq_res -> model shards
    # the residual stream (Megatron sequence parallelism)
    x = constrain(x, "batch", "seq_res", "act_embed")
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    # the sp activation all-gather: attention needs the full sequence
    h = act_gather(h, "batch", None, "act_embed")
    if cfg.family == "mla":
        attn_out, _ = attention.mla_apply(cfg, lp["attn"], h, mode, None, 0, 0)
    else:
        attn_out, _ = attention.gqa_apply(cfg, lp["attn"], h, mode, None, 0, 0)
    if cfg.family == "hybrid":
        ssm_out, _ = ssm.ssm_apply(cfg, lp["ssm"], h, mode, None)
        x = x + 0.5 * (attn_out + ssm_out)
    else:
        x = x + attn_out
    h2 = rms_norm(x, lp["ln2"], cfg.norm_eps)
    h2 = act_gather(h2, "batch", None, "act_embed")   # sp gather, MLP side
    if cfg.family == "moe":
        y, aux = moe.moe_apply(cfg, lp["moe"], h2, mode=mode)
    elif cfg.d_ff > 0:
        y = swiglu(h2, lp["mlp"]["gate"], lp["mlp"]["up"], lp["mlp"]["down"])
    else:
        y = torch.zeros_like(x)
    x = x + y
    return x, aux


def _run_stack(cfg, params, x, mode):
    """Run the stacked layers. Returns (x, aux).

    ``cfg.remat_block`` layers form one rematerialization unit: only the
    unit's input is saved for backward, and the unit runs forward again in
    backward.
    """
    rb = max(1, cfg.remat_block)
    n_units = cfg.n_layers // rb
    assert cfg.n_layers % rb == 0, (cfg.n_layers, rb)
    layers = params["layers"]

    def unit_body(xcur, u):
        aux_tot = {}
        for j in range(rb):
            lp = tree_map(lambda t: t[u * rb + j], layers)
            xcur, aux = _layer_body(cfg, mode, xcur, lp)
            for k, v in aux.items():
                aux_tot[k] = aux_tot.get(k, 0.0) + v
        return xcur, aux_tot

    aux_acc = {}
    if cfg.family == "moe":
        aux_acc = {k: torch.zeros((), dtype=torch.float32, device=x.device)
                   for k in MOE_AUX}
    for u in range(n_units):
        x, aux = checkpoint(unit_body, x, u, use_reentrant=False)
        aux_acc = {k: aux_acc[k] + aux[k] for k in aux_acc}
    if cfg.family == "moe":
        aux_acc = {k: v / cfg.n_layers for k, v in aux_acc.items()}
    return x, aux_acc


def _run_xlstm(cfg, params, x, mode):
    for i, bp in enumerate(params["blocks"]):
        fn = xlstm.mlstm_apply if xlstm.is_mlstm_layer(cfg, i) else xlstm.slstm_apply
        x, _ = checkpoint(fn, cfg, bp, x, mode, None, use_reentrant=False)
    return x, {}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _embed_inputs(cfg, params, batch, mode):
    if cfg.frontend == "audio_frames":
        return constrain(einsum("bsf,fd->bsd", batch["frames"],
                                params["audio_adapter"]),
                         "batch", None, "act_embed")
    tok = params["embed"][batch["tokens"].long()]
    tok = constrain(tok, "batch", None, "act_embed")
    if cfg.frontend == "vit_patches" and mode != "decode":
        vis = einsum("bpf,fd->bpd", batch["patches"],
                     params["vision_adapter"])
        return constrain(torch.cat([vis, tok], dim=1),
                         "batch", None, "act_embed")
    return tok


def _logits(cfg, params, x):
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    out = einsum("...d,dv->...v", x, head)
    return constrain(out, *(("batch",) + (None,) * (out.ndim - 2) + ("vocab",)))


def forward(cfg: ModelConfig, params, batch: Dict[str, Any],
            mode: str = "train"):
    """``mode="train"`` -> (loss, metrics) with the reference's metric
    names: ``ce_loss`` and ``loss``, and for MoE the three aux terms
    averaged over layers, which enter the loss with weights 0.01 (load
    balance) and ``cfg.router_aux_weight`` (z-loss). Runs where the
    tensors are."""
    require_train(mode, "forward")
    x = _embed_inputs(cfg, params, batch, mode)
    if cfg.family == "ssm_xlstm":
        x, aux = _run_xlstm(cfg, params, x, mode)
    else:
        x, aux = _run_stack(cfg, params, x, mode)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)

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


# ---------------------------------------------------------------------------
# public param API
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, *, seed: int,
                device: Union[str, torch.device, None] = None):
    """A parameter tree of ``param_specs(cfg)``'s shapes and dtypes, drawn
    from ``seed``; on the card unless ``device`` names another."""
    return tree_init(param_specs(cfg), seed,
                     resolve_device(device, "init_params"))


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

    def forward(self, batch: Dict[str, Any], mode: str = "train"):
        return forward(self.cfg, self.params(), batch, mode)
