"""Plain PyTorch version of flash-decode: the CPU path and the oracle."""

from __future__ import annotations

import math

import torch


def decode_attention_ref(q, k, v, lengths):
    """q: (B,H,D); k,v: (B,S,Hkv,D); lengths: (B,).

    Positions at or past ``lengths[b]`` score -1e30 before the softmax, so
    a row with ``lengths[b] == 0`` averages v over all S positions.
    """
    b, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    group = h // hkv
    k = torch.repeat_interleave(k, group, dim=2)        # (B,S,H,D)
    v = torch.repeat_interleave(v, group, dim=2)
    scores = torch.einsum("bhd,bshd->bhs", q.to(torch.float32),
                          k.to(torch.float32)) / math.sqrt(d)
    pos = torch.arange(s, device=q.device)
    valid = pos[None, None, :] < lengths.to(q.device)[:, None, None]
    scores = torch.where(valid, scores, torch.full_like(scores, -1e30))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhs,bshd->bhd", p, v.to(torch.float32))
    return out.to(q.dtype)
