"""The plain reference of Granite-4.0-H (``GraniteMoeHybrid``), after the
published ``modeling_granitemoehybrid.py``: the token embedding times
``embedding_multiplier``, then per layer RMSNorm, the layer's mixer (a
Mamba-2 layer or NoPE grouped-query attention), a residual add of the
mixer's output times ``residual_multiplier``, RMSNorm, the MoE (a router
whose top-k logits are softmaxed into the gates, each token's chosen
experts' SwiGLUs weighted and summed) plus the shared SwiGLU, and a
residual add of their sum times ``residual_multiplier``; a final RMSNorm
and logits on the tied embedding divided by ``logits_scaling``.

The Mamba-2 layer (``GraniteMoeHybridMambaLayer``): ``in_proj`` split
into the gate z, xBC and dt; a causal depthwise conv with bias over xBC
and SiLU; xBC split into x, B and C (B and C shared by the heads of a
group); ``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)``; the
recurrence run position by position, per head, channel and state,

    h[t] = exp(dt[t] A) h[t-1] + dt[t] x[t] B[t],  y[t] = C[t] h[t] + D x[t];

``y * silu(z)``, RMS-normed over the inner width with its weight, and
``out_proj``. Attention: q, k and v projected without bias and without
rotary positions, softmax scale ``attention_multiplier``, causal.

Departures from ``modeling_granitemoehybrid.py``:

- the recurrence is the sequential one (the published code runs the SSD
  chunked form in prefill and this recurrence in decode; the two are the
  same sum);
- ``in_proj``, the conv weight (``conv_w``, a tap a row) and each expert's
  ``input_linear`` (as ``w_gate`` and ``w_up``, its two halves) are read
  as the benchmark's leaves, and each projection as an einsum over the
  tree's layout;
- the whole forward runs in f32, the router's top-k softmax included (the
  published bf16 model casts the gates back to bf16).

Plain PyTorch in float32 with TF32 off, no kernels, no cache, no batching
of requests. It reads the benchmark's weight tree by the names of its
leaves (``embed``, ``layers.ssm.in_proj``, ``attn_layers.attn.wq``...),
upcast one layer at a time, routes on its own f32 logits, and imports
nothing of the program. ``dense_lm.Precision("fp8")`` is the control: the
operands of every weight's product rounded to float8 e4m3, as in
``dense_lm``.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from reference.dense_lm import Precision, causal_attention, f32_exact, \
    rms_norm


def mamba(cfg: Dict, lw: Dict[str, torch.Tensor], h: torch.Tensor,
          prec: Precision) -> torch.Tensor:
    """The Mamba-2 mixer on one sequence h (T, d), normed."""
    t = h.shape[0]
    heads, pd = cfg["mamba_n_heads"], cfg["mamba_d_head"]
    g, n = cfg["mamba_n_groups"], cfg["mamba_d_state"]
    di = cfg["mamba_expand"] * cfg["hidden_size"]
    k = cfg["mamba_d_conv"]
    proj = h @ prec.weight(lw["in_proj"], (0,))
    z, xbc, dt = torch.split(proj, [di, di + 2 * g * n, heads], dim=-1)
    # causal depthwise conv: out[t] = b + sum_i w[i] xbc[t - (k-1) + i]
    xbc = F.conv1d(xbc.T[None], lw["conv_w"].T[:, None, :], lw["conv_b"],
                   padding=k - 1, groups=xbc.shape[1])[0, :, :t].T
    xbc = F.silu(xbc)
    x, b, c = torch.split(xbc, [di, g * n, g * n], dim=-1)
    x = x.reshape(t, heads, pd)
    b = b.reshape(t, g, n).repeat_interleave(heads // g, dim=1)
    c = c.reshape(t, g, n).repeat_interleave(heads // g, dim=1)
    dt = F.softplus(dt + lw["dt_bias"])                      # (T, heads)
    a = -torch.exp(lw["a_log"])
    state = torch.zeros(heads, pd, n, device=h.device)
    ys = []
    for s in range(t):
        state = torch.exp(dt[s] * a)[:, None, None] * state \
            + (dt[s, :, None] * x[s])[:, :, None] * b[s][:, None, :]
        ys.append(torch.einsum("hpn,hn->hp", state, c[s]))
    y = torch.stack(ys) + lw["d_skip"][:, None] * x
    y = y.reshape(t, di) * F.silu(z)
    y = rms_norm(y, lw["norm"], float(cfg["rms_norm_eps"]))
    return prec.act(y) @ prec.weight(lw["out_proj"], (0,))


def attention(cfg: Dict, lw: Dict[str, torch.Tensor], h: torch.Tensor,
              prec: Precision) -> torch.Tensor:
    """Causal NoPE GQA over one sequence h (T, d), normed; the output
    projected back to d. ``causal_attention`` scales by 1/sqrt(head
    dim); the queries are rescaled so that the softmax scale is
    ``attention_multiplier``."""
    q = torch.einsum("td,dhk->thk", h, prec.weight(lw["wq"], (0,)))
    k = torch.einsum("td,dhk->thk", h, prec.weight(lw["wk"], (0,)))
    v = torch.einsum("td,dhk->thk", h, prec.weight(lw["wv"], (0,)))
    hd = q.shape[-1]
    q = q * (float(cfg["attention_multiplier"]) * hd ** 0.5)
    o = causal_attention(q, k, v)
    return torch.einsum("thk,hkd->td", prec.act(o.flatten(1)).view_as(o),
                        prec.weight(lw["wo"], (0, 1)))


def mlp(x, gate, up, down, prec: Precision) -> torch.Tensor:
    """A SwiGLU on rows x (n, d)."""
    g = x @ prec.weight(gate, (0,))
    u = x @ prec.weight(up, (0,))
    return prec.act(F.silu(g) * u) @ prec.weight(down, (0,))


def moe(cfg: Dict, lw: Dict[str, torch.Tensor], h: torch.Tensor,
        prec: Precision) -> torch.Tensor:
    """``GraniteMoeHybridMoE`` plus the shared expert on rows h (T, d),
    normed: the top-k of the f32 router logits, softmaxed into the gates;
    each expert run on the rows that chose it."""
    logits = h @ prec.weight(lw["router"], (0,))
    top, idx = torch.topk(logits, cfg["num_experts_per_tok"], dim=-1)
    w = torch.softmax(top, dim=-1)
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
    r = float(cfg["residual_multiplier"])
    h = prec.act(rms_norm(x, lw["ln1"], eps))
    mixer = attention if "wq" in lw else mamba
    x = x + r * mixer(cfg, lw, h, prec)
    h = prec.act(rms_norm(x, lw["ln2"], eps))
    return x + r * moe(cfg, lw, h, prec)


def layer_weights(weights: Dict, i: int, cfg: Dict) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s leaves of the benchmark's tree, upcast to f32: an
    attention layer's from ``attn_layers``, a Mamba-2 layer's from
    ``layers``, each at its place among the layers of its kind."""
    kinds = cfg["layer_types"]
    j = sum(1 for k in kinds[:i] if k == kinds[i])
    lay = weights["attn_layers" if kinds[i] == "attention" else "layers"]
    out = {"ln1": lay["ln1"][j], "ln2": lay["ln2"][j]}
    for part in ("attn", "ssm", "moe"):
        if part in lay:
            out.update({k: lay[part][k][j] for k in lay[part]})
    return {k: v.float() for k, v in out.items()}


def logits(cfg: Dict, weights: Dict, seqs: List[torch.Tensor],
           rows: List[torch.Tensor], prec: Precision = Precision()
           ) -> List[torch.Tensor]:
    """For each token sequence ``seqs[i]`` (T_i,), the f32 logits (n_i,
    V) at its positions ``rows[i]``. Layer by layer over all sequences, so
    one layer's f32 weights are held at a time."""
    f32_exact()
    mult = float(cfg["embedding_multiplier"])
    xs = [weights["embed"][s.long()].float() * mult for s in seqs]
    for i in range(cfg["num_hidden_layers"]):
        lw = layer_weights(weights, i, cfg)
        xs = [layer(cfg, lw, x, prec) for x in xs]
        del lw
    eps = float(cfg["rms_norm_eps"])
    fn = weights["final_norm"].float()
    head = prec.weight(weights["embed"].float().T, (0,))
    scale = float(cfg["logits_scaling"])
    return [(prec.act(rms_norm(x[r], fn, eps)) @ head) / scale
            for x, r in zip(xs, rows)]
