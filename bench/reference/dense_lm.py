"""The plain reference of a dense decoder (Granite-3's block as the port's
configuration runs it): token embedding, then per layer RMSNorm, grouped-
query causal attention with rotary positions (rotate-half), a residual add,
RMSNorm, a SwiGLU MLP and a residual add; a final RMSNorm and logits on the
tied embedding.

Plain PyTorch in float32 with TF32 off, no kernels, no cache, no batching
of requests. It reads the benchmark's weight tree by the names of its
leaves (``embed``, ``layers.attn.wq``...), upcast one layer at a time, and
imports nothing of the program.

``Precision`` is the arithmetic: ``"f32"``, or ``"fp8"``, the control, in
which the operands of every matrix product are rounded to float8 e4m3 (per
output channel for weights, per row for activations) before an f32 product.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def f32_exact() -> None:
    """No TF32 in float32 products, on the card or off it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Precision:
    def __init__(self, kind: str = "f32") -> None:
        if kind not in ("f32", "fp8"):
            raise ValueError(kind)
        self.kind = kind

    def act(self, x: torch.Tensor) -> torch.Tensor:
        """An activation entering a product, rounded per row."""
        return x if self.kind == "f32" else _e4m3(x, dim=-1)

    def weight(self, w: torch.Tensor, contract: Sequence[int]) -> torch.Tensor:
        """A weight entering a product, rounded per output channel (its
        scale taken over the contracted dims)."""
        return w if self.kind == "f32" else _e4m3(w, dim=tuple(contract))


def _e4m3(x: torch.Tensor, dim) -> torch.Tensor:
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (T, H, D) at positions pos (T,); the first and second halves of
    D rotate as pairs."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64,
                                       device=x.device) / d)
    ang = (pos.double()[:, None] * inv[None, :]).float()[:, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v) -> torch.Tensor:
    """q: (T, H, D), k, v: (T, Hkv, D) -> (T, H, D); query t sees keys
    0..t."""
    t, h, d = q.shape
    hkv = k.shape[1]
    qg = q.reshape(t, hkv, h // hkv, d)
    s = torch.einsum("thgd,shd->hgts", qg, k) / math.sqrt(d)
    mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hgts,shd->thgd", p, v).reshape(t, h, d)


def layer(cfg: Dict, lw: Dict[str, torch.Tensor], x: torch.Tensor,
          prec: Precision) -> torch.Tensor:
    """One block on one sequence x (T, d), weights of this layer in f32."""
    eps, theta = float(cfg["rms_norm_eps"]), float(cfg["rope_theta"])
    pos = torch.arange(x.shape[0], device=x.device)
    h = prec.act(rms_norm(x, lw["ln1"], eps))
    q = torch.einsum("td,dhk->thk", h, prec.weight(lw["wq"], (0,)))
    k = torch.einsum("td,dhk->thk", h, prec.weight(lw["wk"], (0,)))
    v = torch.einsum("td,dhk->thk", h, prec.weight(lw["wv"], (0,)))
    o = causal_attention(rope(q, pos, theta), rope(k, pos, theta), v)
    x = x + torch.einsum("thk,hkd->td", prec.act(o.flatten(1))
                         .view_as(o), prec.weight(lw["wo"], (0, 1)))
    h2 = prec.act(rms_norm(x, lw["ln2"], eps))
    g = h2 @ prec.weight(lw["gate"], (0,))
    u = h2 @ prec.weight(lw["up"], (0,))
    return x + prec.act(F.silu(g) * u) @ prec.weight(lw["down"], (0,))


def layer_weights(weights: Dict, i: int) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s leaves of the benchmark's tree, upcast to f32."""
    lay = weights["layers"]
    out = {"ln1": lay["ln1"][i], "ln2": lay["ln2"][i]}
    out.update({k: lay["attn"][k][i] for k in lay["attn"]})
    out.update({k: lay["mlp"][k][i] for k in lay["mlp"]})
    return {k: v.float() for k, v in out.items()}


def logits(cfg: Dict, weights: Dict, seqs: List[torch.Tensor],
           rows: List[torch.Tensor], prec: Precision = Precision()
           ) -> List[torch.Tensor]:
    """For each token sequence ``seqs[i]`` (T_i,), the f32 logits (n_i,
    V) at its positions ``rows[i]``. Layer by layer over all sequences, so
    one layer's f32 weights are held at a time."""
    f32_exact()
    emb = weights["embed"]
    xs = [emb[s.long()].float() for s in seqs]
    for i in range(cfg["num_hidden_layers"]):
        lw = layer_weights(weights, i)
        xs = [layer(cfg, lw, x, prec) for x in xs]
        del lw
    eps = float(cfg["rms_norm_eps"])
    fn = weights["final_norm"].float()
    head = prec.weight(emb.float(), (1,))
    out = [prec.act(rms_norm(x[r], fn, eps)) @ head.T
           for x, r in zip(xs, rows)]
    return out
