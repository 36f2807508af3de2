"""Attention layers: GQA (optional QKV bias, optional sliding window) and
MLA (Multi-head Latent Attention, MiniCPM3/DeepSeek-style).

The port of ``src/repro/models/attention.py``. Each layer exposes
``specs(cfg)`` (parameter declarations) and
``apply(cfg, p, x, mode, cache, pos)`` -> (out, new_cache), for
``mode`` "train", "encode", "prefill" and "decode".

Cache layouts (per layer, no leading layers axis here):
  GQA : {"k": (B, S_c, Hkv, D), "v": (B, S_c, Hkv, D)}   S_c = window or seq
  MLA : {"latent": (B, S_c, kv_lora), "k_rope": (B, S_c, 1, rope_dim)}
Cached K is stored post-RoPE. The reference writes a cache with
``dynamic_update_slice`` and reads it with plain jnp; the port writes a
new tensor (the caller's cache is never changed in place) and reads it
with the same f32 math.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs import ModelConfig
from repro_torch.dist import collectives
from repro_torch.dist.sharding import constrain, is_dtensor, mesh_axis_size
from repro_torch.models import common
from repro_torch.models.common import (
    Spec, apply_rope, as_positions, blockwise_attention, decode_attention,
    einsum,
)


# ---------------------------------------------------------------------------
# slot bookkeeping for (ring) caches
# ---------------------------------------------------------------------------

def cache_slot_positions(cache_len_total: int, size: int, pos,
                         device=None) -> torch.Tensor:
    """Absolute position held by each cache slot, -1 if empty.

    For a full cache (size >= max seq) slot i holds position i (valid iff
    i <= pos). For a ring buffer of ``size`` slots, slot i holds the largest
    p <= pos with p % size == i (valid iff p >= 0); assumes contiguous fill.
    ``pos`` may be a scalar (returns (S,)) or per-row (B,) (returns (B,S)).
    """
    pos = as_positions(pos, device)
    idx = torch.arange(size, dtype=torch.int32, device=pos.device)
    pos = pos.reshape(pos.shape + (1,))              # () -> (1,), (B,) -> (B,1)
    if cache_len_total <= size:  # full cache
        return torch.where(idx <= pos, idx, -1).to(torch.int32)
    p = pos - torch.remainder(pos - idx, size)       # floor mod, as jnp's %
    return torch.where(p >= 0, p, -1).to(torch.int32)


def ring_update(buf: torch.Tensor, new: torch.Tensor, pos) -> torch.Tensor:
    """``new`` (B, 1, ...) written at slot pos % size of a copy of ``buf``
    (B, size, ...).

    ``pos`` scalar writes one slot for the whole batch; per-row (B,) writes
    each row at its own slot (ragged continuous batching).
    """
    size = buf.shape[1]
    pos = as_positions(pos, buf.device)
    if is_dtensor(buf):
        return _ring_update_shards(buf, new, pos)
    slot = torch.remainder(pos, size).long()         # pos >= 0: lax.rem
    if pos.ndim == 0:
        # a tensor index, so no host sync
        return collectives.index_copy(buf, 1, slot.reshape(1), new)
    # (B,): row b's slot in the flattened (B * size) rows
    flat = torch.arange(buf.shape[0], device=buf.device) * size + slot
    out = collectives.index_copy(buf.reshape((-1,) + tuple(buf.shape[2:])),
                                 0, flat, new[:, 0])
    return out.reshape(buf.shape)


def _ring_update_shards(buf, new, pos):
    """:func:`ring_update` of a DTensor cache: each rank writes the rows
    and slots of its own shard, reading ``new`` laid out as ``buf`` with
    the slot dim whole; the cache keeps its layout. Every local row is
    written, a row whose slot lies outside this shard with its own old
    bytes, so no shape depends on the positions' values (no host sync,
    and fake tensors can trace it)."""
    size = buf.shape[1]
    new = collectives.redistribute("reshard", collectives.as_dtensor(new, buf),
                                   collectives.without_dims(
                                       buf.placements, (1,), buf.ndim))
    if is_dtensor(pos):
        pos = pos.full_tensor()
    local, nl = buf.to_local(), new.to_local()
    off = collectives.local_offsets(buf)
    rows = torch.arange(local.shape[0], device=local.device)
    pos_b = pos.reshape(-1).expand(buf.shape[0])[rows + off[0]]
    slot = torch.remainder(pos_b, size).long() - off[1]
    hit = (slot >= 0) & (slot < local.shape[1])
    slot = slot.clamp(0, local.shape[1] - 1)
    out = collectives._bytes(local).clone()
    old = out[rows, slot]
    hit = hit.reshape((-1,) + (1,) * (old.ndim - 1))
    out[rows, slot] = torch.where(
        hit, collectives._bytes(nl.to(local.dtype))[:, 0], old)
    return collectives.from_local(out.view(local.dtype), buf)


def paged_decode_attention(q, k_pool, v_pool, page_table, k_positions, pos,
                           k_scale_pool=None, v_scale_pool=None):
    """Single-token attention reading one layer's K/V through a page table.

    ``k_pool``/``v_pool`` are page pools ``(n_pool, page, Hkv, D)``;
    ``page_table`` is the per-row table ``(B, pages_per_row)`` with -1
    marking unallocated pages. The pools are gathered back to the dense
    per-row layout (``kernels.paged_attn.gather_pages``) and handed to
    :func:`repro_torch.models.common.decode_attention` unchanged, so the
    paged read equals the dense one bit for bit: junk gathered from
    unallocated (-1 -> clamped) entries sits at positions the mask sends
    to NEG_INF before the softmax. Quantized (int8) pools pass their scale
    pools the same way.
    """
    from repro_torch.kernels.paged_attn import gather_pages
    k = gather_pages(k_pool, page_table)
    v = gather_pages(v_pool, page_table)
    ks = None if k_scale_pool is None else gather_pages(k_scale_pool, page_table)
    vs = None if v_scale_pool is None else gather_pages(v_scale_pool, page_table)
    return decode_attention(q, k, v, k_positions, pos, ks, vs)


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------

def gqa_specs(cfg: ModelConfig) -> Dict[str, Spec]:
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = {
        "wq": Spec((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": Spec((d, hkv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": Spec((d, hkv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": Spec((h, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        s["bq"] = Spec((h, hd), ("heads", "head_dim"), init="zeros")
        s["bk"] = Spec((hkv, hd), ("kv_heads", "head_dim"), init="zeros")
        s["bv"] = Spec((hkv, hd), ("kv_heads", "head_dim"), init="zeros")
    return s


def gqa_apply(cfg: ModelConfig, p, x: torch.Tensor, mode: str,
              cache: Optional[dict], pos, cache_len_total: int,
              ) -> Tuple[torch.Tensor, Optional[dict]]:
    b, s, _ = x.shape
    q = einsum("bsd,dhk->bshk", x, p["wq"])
    k = einsum("bsd,dhk->bshk", x, p["wk"])
    v = einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = constrain(q, "batch", None, "heads", None)
    k = constrain(k, "batch", None, "kv_heads", None)
    v = constrain(v, "batch", None, "kv_heads", None)

    if mode == "decode":
        pos_t = as_positions(pos, x.device)
        pos_bt = pos_t.reshape(pos_t.shape + (1,)).expand(b, 1)  # scalar or (B,)
        q = apply_rope(q, pos_bt, cfg.rope_theta)
        k = apply_rope(k, pos_bt, cfg.rope_theta)
        size = cache["k"].shape[1]
        cache_sp = ("batch", "kv_seq", "kv_heads", None)
        storage = collectives.current_kv_storage()
        if storage == "int8":
            # int8-resident cache: the new token's K/V quantized per
            # position along the feature axis, s8 values + f32 scales
            k, k_sc = collectives.quantize_int8_lastdim(k)
            v, v_sc = collectives.quantize_int8_lastdim(v)
            k_scale = constrain(ring_update(cache["k_scale"], k_sc, pos_t),
                                *cache_sp)
            v_scale = constrain(ring_update(cache["v_scale"], v_sc, pos_t),
                                *cache_sp)
        elif storage == "f8":
            # f8-resident cache: scale-free e4m3 cast of the new token's K/V
            k = collectives.cast_f8(k)
            v = collectives.cast_f8(v)
        k_cache = constrain(ring_update(cache["k"], k, pos_t), *cache_sp)
        v_cache = constrain(ring_update(cache["v"], v, pos_t), *cache_sp)
        kpos = cache_slot_positions(cache_len_total + 1, size, pos_t)
        if cfg.attn_window:
            win_lo = pos_t.reshape(pos_t.shape + (1,)) - cfg.attn_window
            kpos = torch.where(kpos > win_lo, kpos, -1)
        # decode's activation all-gather: the cache gathered to a
        # head-replicated layout (s8 under act_transport="int8"; an int8-
        # or f8-resident cache passes through as it is)
        gather_sp = ("batch", None, None, None)
        k_att = collectives.act_gather(k_cache, *gather_sp)
        v_att = collectives.act_gather(v_cache, *gather_sp)
        if storage == "int8":
            out = decode_attention(q, k_att, v_att, kpos, pos_t,
                                   k_scale=constrain(k_scale, *gather_sp),
                                   v_scale=constrain(v_scale, *gather_sp))
            new_cache = {"k": k_cache, "v": v_cache,
                         "k_scale": k_scale, "v_scale": v_scale}
        else:
            out = decode_attention(q, k_att, v_att, kpos, pos_t)
            new_cache = {"k": k_cache, "v": v_cache}
    else:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)[None, :]
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        new_cache = None
        if mode == "prefill":
            size = cfg.attn_window or s
            new_cache = {"k": k[:, -size:].to(common.COMPUTE_DTYPE),
                         "v": v[:, -size:].to(common.COMPUTE_DTYPE)}
        # TP > kv_heads: replicate KV across query-head groups so attention
        # activations stay head-sharded (MaxText-style KV replication).
        tp = mesh_axis_size("model")
        h, hkv = cfg.n_heads, cfg.n_kv_heads
        if tp > 1 and h % tp == 0 and hkv % tp != 0:
            rep = h // hkv
            k = constrain(torch.repeat_interleave(k, rep, dim=2), "batch", None, "heads", None)
            v = constrain(torch.repeat_interleave(v, rep, dim=2), "batch", None, "heads", None)
        out = blockwise_attention(q, k, v, causal=cfg.causal,
                                  window=cfg.attn_window)
    y = constrain(einsum("bshk,hkd->bsd", out, p["wo"]),
                  "batch", None, "act_embed")
    return y, new_cache


def gqa_cache_shape(cfg: ModelConfig, batch: int, seq: int):
    size = min(cfg.attn_window, seq) if cfg.attn_window else seq
    kv = (batch, size, cfg.n_kv_heads, cfg.head_dim)
    return {"k": kv, "v": kv}


def gqa_cache_axes():
    """Logical axes of the GQA ring-buffer cache leaves (the stack
    prepends its "layers" axis). ``kv_seq`` marks the slice-admission
    axis."""
    kv = ("batch", "kv_seq", "kv_heads", "head_dim")
    return {"k": kv, "v": kv}


# ---------------------------------------------------------------------------
# MLA (latent KV cache)
# ---------------------------------------------------------------------------

def mla_specs(cfg: ModelConfig) -> Dict[str, Spec]:
    d, h = cfg.d_model, cfg.n_heads
    rq, rkv = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
    return {
        "wq_a": Spec((d, rq), ("embed", "q_lora")),
        "wq_b": Spec((rq, h, dn + dr), ("q_lora", "heads", "head_dim")),
        "wkv_a": Spec((d, rkv + dr), ("embed", "kv_lora")),
        "wk_b": Spec((rkv, h, dn), ("kv_lora", "heads", "head_dim")),
        "wv_b": Spec((rkv, h, dv), ("kv_lora", "heads", "head_dim")),
        "wo": Spec((h, dv, d), ("heads", "head_dim", "embed")),
        "q_norm": Spec((rq,), ("q_lora",), init="ones"),
        "kv_norm": Spec((rkv,), ("kv_lora",), init="ones"),
    }


def _mla_qk(cfg, p, x, positions):
    """Project to per-head q (nope|rope) and latent kv. x:(B,S,d)."""
    dn = cfg.nope_head_dim
    cq = common.rms_norm(einsum("bsd,dr->bsr", x, p["wq_a"]), p["q_norm"],
                         cfg.norm_eps)
    q = einsum("bsr,rhk->bshk", cq, p["wq_b"])              # (B,S,H,dn+dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    kv = einsum("bsd,dr->bsr", x, p["wkv_a"])               # (B,S,rkv+dr)
    latent = common.rms_norm(kv[..., :cfg.kv_lora_rank], p["kv_norm"],
                             cfg.norm_eps)
    k_rope = apply_rope(kv[..., None, cfg.kv_lora_rank:], positions,
                        cfg.rope_theta)[..., 0, :]          # (B,S,dr) shared
    return torch.cat([q_nope, q_rope], -1), latent, k_rope


def _mla_expand(cfg, p, latent, k_rope):
    """Expand latent into per-head K (nope|rope-shared) and V."""
    k_nope = einsum("bsr,rhk->bshk", latent, p["wk_b"])
    v = einsum("bsr,rhk->bshk", latent, p["wv_b"])
    kr = k_rope[:, :, None, :].expand(*k_nope.shape[:3], cfg.rope_head_dim)
    return torch.cat([k_nope, kr], -1), v


def mla_apply(cfg: ModelConfig, p, x, mode, cache, pos, cache_len_total):
    b, s, _ = x.shape
    if mode == "decode":
        pos_t = as_positions(pos, x.device)
        positions = pos_t.reshape(pos_t.shape + (1,)).expand(b, 1)
        q, latent, k_rope = _mla_qk(cfg, p, x, positions)
        storage = collectives.current_kv_storage()
        kr_new = k_rope[:, :, None, :]
        if storage == "f8":
            # f8-resident latent cache, upcast at the latent expansion
            latent = collectives.cast_f8(latent)
            kr_new = collectives.cast_f8(kr_new)
        if storage == "int8":
            # int8-resident latent cache, dequantized just before the
            # per-head expansion (MLA's read-time boundary)
            latent, lat_sc = collectives.quantize_int8_lastdim(latent)
            kr_new, kr_sc = collectives.quantize_int8_lastdim(kr_new)
            lat_scale = constrain(ring_update(cache["latent_scale"], lat_sc,
                                              pos_t), "batch", "kv_seq", None)
            kr_scale = constrain(ring_update(cache["k_rope_scale"], kr_sc,
                                             pos_t), "batch", "kv_seq", None,
                                 None)
        lat_cache = constrain(ring_update(cache["latent"], latent, pos_t),
                              "batch", "kv_seq", None)
        kr_cache = constrain(ring_update(cache["k_rope"], kr_new, pos_t),
                             "batch", "kv_seq", None, None)
        # decode's activation all-gather, MLA form: the latent cache
        lat_att = collectives.act_gather(lat_cache, "batch", None, None)
        kr_att = collectives.act_gather(kr_cache, "batch", None, None, None)
        if storage == "int8":
            lat_att = collectives.dequantize_int8_lastdim(
                lat_att, constrain(lat_scale, "batch", None, None))
            kr_att = collectives.dequantize_int8_lastdim(
                kr_att, constrain(kr_scale, "batch", None, None, None))
            lat_att = lat_att.to(x.dtype)
            kr_att = kr_att.to(x.dtype)
        elif storage == "f8":
            lat_att = collectives.uncast_f8(lat_att, x.dtype)
            kr_att = collectives.uncast_f8(kr_att, x.dtype)
        k, v = _mla_expand(cfg, p, lat_att, kr_att[..., 0, :])
        kpos = cache_slot_positions(cache_len_total + 1, lat_cache.shape[1],
                                    pos_t)
        out = decode_attention(q, k, v, kpos, pos_t)
        new_cache = {"latent": lat_cache, "k_rope": kr_cache}
        if storage == "int8":
            new_cache["latent_scale"] = lat_scale
            new_cache["k_rope_scale"] = kr_scale
    else:
        positions = torch.arange(s, dtype=torch.int32, device=x.device)[None, :]
        q, latent, k_rope = _mla_qk(cfg, p, x, positions)
        k, v = _mla_expand(cfg, p, latent, k_rope)
        out = blockwise_attention(q, k, v, causal=cfg.causal)
        new_cache = None
        if mode == "prefill":
            new_cache = {"latent": latent.to(common.COMPUTE_DTYPE),
                         "k_rope": k_rope[:, :, None, :].to(common.COMPUTE_DTYPE)}
    y = constrain(einsum("bshk,hkd->bsd", out, p["wo"]),
                  "batch", None, "act_embed")
    return y, new_cache


def mla_cache_shape(cfg: ModelConfig, batch: int, seq: int):
    return {"latent": (batch, seq, cfg.kv_lora_rank),
            "k_rope": (batch, seq, 1, cfg.rope_head_dim)}


def mla_cache_axes():
    """Logical axes of the MLA latent-cache leaves (the stack prepends its
    "layers" axis)."""
    return {"latent": ("batch", "kv_seq", "kv_lora"),
            "k_rope": ("batch", "kv_seq", None, None)}
