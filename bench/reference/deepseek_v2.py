"""The plain reference of DeepSeek-V2(-Lite), after the published
``modeling_deepseek.py``: token embedding, then per layer RMSNorm,
multi-head latent attention, a residual add, RMSNorm, the layer's FFN
(a SwiGLU in the first ``first_k_dense_replace`` layers, else the MoE:
a softmax router in f32, its greedy top-k scores as gates, not
renormalised unless ``norm_topk_prob``, times ``routed_scaling_factor``,
each token's chosen experts' SwiGLUs weighted and summed, plus the shared
experts' SwiGLU) and a residual add; a final RMSNorm and logits on the
untied output head.

Attention in its expanded form: the query projected directly (no
q-LoRA), the KV latent RMS-normed and expanded per head into K (nope
dims) and V, the rope dims of the query and of the one shared rope key
rotated at YaRN's frequencies (``yarn_find_correction_range``,
``yarn_linear_ramp_mask``; cos and sin times ``mscale /
mscale_all_dim``), and the softmax scale ``q_head_dim ** -0.5`` times
``yarn_get_mscale(factor, mscale_all_dim) ** 2``.

Departures from ``modeling_deepseek.py``:

- the rope dims rotate in halves as drawn (the checkpoint interleaves
  them and the published code permutes them to halves before
  ``rotate_half``; on drawn weights the two are the same model with the
  columns relabelled);
- ``kv_b_proj`` is read as the benchmark's two leaves, ``wk_b`` and
  ``wv_b``, and each projection as an einsum over the tree's layout;
- each chosen expert's output is weighted and summed in f32 and the
  whole forward runs in f32 (the published code's bf16 model rounds the
  weighted sum back to bf16 before the shared experts are added).

Plain PyTorch in float32 with TF32 off, no kernels, no cache, no batching
of requests. It reads the benchmark's weight tree by the names of its
leaves (``embed``, ``dense_layers.attn.wq``, ``layers.moe.w_gate``...),
upcast one layer at a time, routes on its own f32 scores, and imports
nothing of the program. ``dense_lm.Precision("fp8")`` is the control:
the operands of every weight's product rounded to float8 e4m3, as in
``dense_lm``.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from reference.dense_lm import Precision, f32_exact, rms_norm


def yarn_get_mscale(scale: float = 1.0, mscale: float = 1.0) -> float:
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def _correction_dim(turns, dim, base, max_pos):
    return (dim * math.log(max_pos / (turns * 2 * math.pi))) \
        / (2 * math.log(base))


def yarn_inv_freq(cfg: Dict, device) -> torch.Tensor:
    """``DeepseekV2YarnRotaryEmbedding``'s ``inv_freq`` for the rope dims."""
    rs, dim = cfg["rope_scaling"], cfg["qk_rope_head_dim"]
    base, factor = float(cfg["rope_theta"]), float(rs["factor"])
    orig = rs["original_max_position_embeddings"]
    ar = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    freq_extra = 1.0 / (base ** ar)
    freq_inter = 1.0 / (factor * base ** ar)
    low = max(math.floor(_correction_dim(rs["beta_fast"], dim, base, orig)),
              0)
    high = min(math.ceil(_correction_dim(rs["beta_slow"], dim, base, orig)),
               dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32,
                                     device=device) - low) / (high - low),
                       0, 1)
    mask = 1.0 - ramp
    return freq_inter * (1 - mask) + freq_extra * mask


def rope(x: torch.Tensor, pos: torch.Tensor, cfg: Dict) -> torch.Tensor:
    """x: (T, H, D) rope dims at positions pos (T,), rotated in halves."""
    rs = cfg["rope_scaling"]
    d = x.shape[-1]
    freqs = torch.outer(pos.float(), yarn_inv_freq(cfg, x.device))
    m = yarn_get_mscale(rs["factor"], rs["mscale"]) \
        / yarn_get_mscale(rs["factor"], rs["mscale_all_dim"])
    cos = (freqs.cos() * m)[:, None, :]
    sin = (freqs.sin() * m)[:, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def softmax_scale(cfg: Dict) -> float:
    rs = cfg["rope_scaling"]
    q_head = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    m = yarn_get_mscale(rs["factor"], rs["mscale_all_dim"]) \
        if rs.get("mscale_all_dim") else 1.0
    return q_head ** -0.5 * m * m


def attention(cfg: Dict, lw: Dict[str, torch.Tensor], h: torch.Tensor,
              prec: Precision) -> torch.Tensor:
    """Causal MLA over one sequence h (T, d), normed; the output projected
    back to d."""
    t = h.shape[0]
    rkv, dn = cfg["kv_lora_rank"], cfg["qk_nope_head_dim"]
    eps = float(cfg["rms_norm_eps"])
    pos = torch.arange(t, device=h.device)
    q = torch.einsum("td,dhk->thk", h, prec.weight(lw["wq"], (0,)))
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    kv = h @ prec.weight(lw["wkv_a"], (0,))
    c = prec.act(rms_norm(kv[:, :rkv], lw["kv_norm"], eps))
    k_pe = kv[:, None, rkv:]
    k_nope = torch.einsum("tr,rhk->thk", c, prec.weight(lw["wk_b"], (0,)))
    v = torch.einsum("tr,rhk->thk", c, prec.weight(lw["wv_b"], (0,)))
    q_pe, k_pe = rope(q_pe, pos, cfg), rope(k_pe, pos, cfg)
    qf = torch.cat([q_nope, q_pe], -1)
    kf = torch.cat([k_nope, k_pe.expand(-1, k_nope.shape[1], -1)], -1)
    s = torch.einsum("thd,shd->hts", qf, kf) * softmax_scale(cfg)
    mask = torch.ones(t, t, dtype=torch.bool, device=h.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    o = torch.einsum("hts,shd->thd", p, v)
    return torch.einsum("thk,hkd->td", prec.act(o.flatten(1)).view_as(o),
                        prec.weight(lw["wo"], (0, 1)))


def mlp(x, gate, up, down, prec: Precision) -> torch.Tensor:
    """A SwiGLU (``DeepseekV2MLP``) on rows x (n, d)."""
    g = x @ prec.weight(gate, (0,))
    u = x @ prec.weight(up, (0,))
    return prec.act(F.silu(g) * u) @ prec.weight(down, (0,))


def moe(cfg: Dict, lw: Dict[str, torch.Tensor], h: torch.Tensor,
        prec: Precision) -> torch.Tensor:
    """``DeepseekV2MoE`` on rows h (T, d), normed: ``MoEGate`` on f32
    scores, each expert run on the rows that chose it, plus the shared
    experts."""
    k = cfg["num_experts_per_tok"]
    scores = torch.softmax(h @ prec.weight(lw["router"], (0,)), dim=-1)
    w, idx = torch.topk(scores, k, dim=-1, sorted=False)
    if k > 1 and cfg["norm_topk_prob"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    else:
        w = w * cfg["routed_scaling_factor"]
    y = torch.zeros_like(h)
    for e in torch.unique(idx).tolist():
        rows, slot = (idx == e).nonzero(as_tuple=True)
        out = mlp(h[rows], lw["w_gate"][e], lw["w_up"][e], lw["w_down"][e],
                  prec)
        y[rows] += out * w[rows, slot][:, None]    # a row picks e once
    return y + mlp(h, lw["shared_gate"], lw["shared_up"], lw["shared_down"],
                   prec)


def layer(cfg: Dict, lw: Dict[str, torch.Tensor], x: torch.Tensor,
          prec: Precision) -> torch.Tensor:
    """One decoder layer on one sequence x (T, d), weights in f32."""
    eps = float(cfg["rms_norm_eps"])
    x = x + attention(cfg, lw, prec.act(rms_norm(x, lw["ln1"], eps)), prec)
    h = prec.act(rms_norm(x, lw["ln2"], eps))
    if "router" in lw:
        return x + moe(cfg, lw, h, prec)
    return x + mlp(h, lw["gate"], lw["up"], lw["down"], prec)


def layer_weights(weights: Dict, i: int, cfg: Dict) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s leaves of the benchmark's tree, upcast to f32: the
    leading dense layers from ``dense_layers``, the rest from ``layers``."""
    nd = cfg["first_k_dense_replace"]
    lay, j = (weights["dense_layers"], i) if i < nd \
        else (weights["layers"], i - nd)
    out = {"ln1": lay["ln1"][j], "ln2": lay["ln2"][j]}
    out.update({k: lay["attn"][k][j] for k in lay["attn"]})
    ffn = lay["mlp"] if i < nd else lay["moe"]
    out.update({k: ffn[k][j] for k in ffn})
    return {k: v.float() for k, v in out.items()}


def logits(cfg: Dict, weights: Dict, seqs: List[torch.Tensor],
           rows: List[torch.Tensor], prec: Precision = Precision()
           ) -> List[torch.Tensor]:
    """For each token sequence ``seqs[i]`` (T_i,), the f32 logits (n_i,
    V) at its positions ``rows[i]``. Layer by layer over all sequences, so
    one layer's f32 weights are held at a time."""
    f32_exact()
    xs = [weights["embed"][s.long()].float() for s in seqs]
    for i in range(cfg["num_hidden_layers"]):
        lw = layer_weights(weights, i, cfg)
        xs = [layer(cfg, lw, x, prec) for x in xs]
        del lw
    eps = float(cfg["rms_norm_eps"])
    fn = weights["final_norm"].float()
    head = prec.weight(weights["lm_head"].float(), (0,))
    return [prec.act(rms_norm(x[r], fn, eps)) @ head
            for x, r in zip(xs, rows)]
