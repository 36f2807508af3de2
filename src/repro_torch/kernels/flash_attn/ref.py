"""Plain PyTorch version of flash attention: masked softmax attention
with GQA, the CPU path and the oracle."""

from __future__ import annotations

import math

import torch


def flash_attention_ref(q, k, v, *, causal=True, window=0):
    """q: (B,H,S,D); k,v: (B,Hkv,S,D). Masked scores are -1e30:
    ``q_pos >= k_pos`` when causal, ``q_pos - k_pos < window`` when a
    window is set."""
    b, h, s, d = q.shape
    hkv = k.shape[1]
    group = h // hkv
    k = torch.repeat_interleave(k, group, dim=1)
    v = torch.repeat_interleave(v, group, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) / math.sqrt(d)
    qp = torch.arange(s, device=q.device)[:, None]
    kp = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if window:
        mask &= (qp - kp) < window
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.to(torch.float32))
    return out.to(q.dtype)
