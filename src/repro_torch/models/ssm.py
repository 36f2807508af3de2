"""Selective SSM (Mamba-style) head used by the Hymba hybrid layer, and
the Mamba-2 mixer of the port's ``hybrid_moe`` family (Granite-4.0-H,
below ``ssm_cache_axes``).

The port of ``src/repro/models/ssm.py``. The (B, c, di, N) state tensors
are built one chunk of ``CHUNK`` positions at a time, so peak memory is
O(B * CHUNK * di * N) instead of O(B * S * di * N). Decode is the exact
single-step recurrence with O(1) state: the conv tail (B, conv-1, di) and
the SSM state (B, di, N).

Within a chunk the reference runs ``jax.lax.associative_scan``, which
torch lacks. Here the same linear recurrence h_t = a_t * h_{t-1} + b_t
runs as a Hillis-Steele scan: log2(chunk) doubling steps, each composing
every position with the one ``step`` places before it. The pairs are
combined in another order than the reference's, so f32 results agree to
rounding, not bit for bit.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.configs import ModelConfig
from repro_torch.dist.sharding import constrain
from repro_torch.models import common
from repro_torch.models.common import Spec, einsum, repeated

DT_RANK = 16
CHUNK = 256


def ssm_specs(cfg: ModelConfig) -> Dict[str, Spec]:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    n = cfg.ssm_state
    return {
        "in_proj": Spec((d, 2, di), ("embed", None, "ssm_inner")),
        "conv_w": Spec((cfg.ssm_conv, di), ("conv", "ssm_inner")),
        "x_proj": Spec((di, DT_RANK + 2 * n), ("ssm_inner", None)),
        "dt_proj": Spec((DT_RANK, di), (None, "ssm_inner")),
        "dt_bias": Spec((di,), ("ssm_inner",), init="zeros"),
        "a_log": Spec((di, n), ("ssm_inner", "ssm_state"), init="small",
                      dtype=torch.float32),
        "d_skip": Spec((di,), ("ssm_inner",), init="ones", dtype=torch.float32),
        "out_proj": Spec((di, d), ("ssm_inner", "embed")),
    }


def _ssm_inputs(cfg, p, xz):
    """Gate/state projections. xz: post-conv activations (B, c, di)."""
    n = cfg.ssm_state
    dbc = einsum("bsi,ir->bsr", xz, p["x_proj"])
    dt_low, bmat, cmat = torch.split(dbc, [DT_RANK, n, n], dim=-1)
    dt = F.softplus(
        einsum("bsr,ri->bsi", dt_low, p["dt_proj"]).float()
        + p["dt_bias"].float())                                  # (B,c,di)
    a = -torch.exp(p["a_log"])                                  # (di,N)
    da = torch.exp(dt[..., None] * a)                           # (B,c,di,N)
    dbx = (dt * xz.float())[..., None] * bmat.float()[:, :, None, :]
    return da, dbx, cmat.float()


def _causal_conv(p, x, conv_state=None):
    """Depthwise causal conv. x:(B,S,di); conv_state:(B,K-1,di) or None."""
    k = p["conv_w"].shape[0]
    if conv_state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * p["conv_w"][i] for i in range(k))
    new_state = xp[:, -(k - 1):]
    return F.silu(out), new_state


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of h_t = a_t * h_{t-1} + b_t along axis 1 from h = 0:
    returns (prod of a up to t, h_t), the pair ``associative_scan`` gives
    with the reference's ``combine``."""
    n = a.shape[1]
    step = 1
    while step < n:
        b = torch.cat([b[:, :step], a[:, step:] * b[:, :-step] + b[:, step:]], 1)
        a = torch.cat([a[:, :step], a[:, step:] * a[:, :-step]], 1)
        step *= 2
    return a, b


def ssm_apply(cfg: ModelConfig, p, x: torch.Tensor, mode: str,
              cache: Optional[dict]) -> Tuple[torch.Tensor, Optional[dict]]:
    """x: (B,S,d). cache: {"conv": (B,K-1,di), "ssm": (B,di,N)} for decode."""
    proj = constrain(einsum("bsd,dzi->bszi", x, p["in_proj"]),
                     "batch", None, None, "ssm_inner")
    xin, z = proj[:, :, 0], proj[:, :, 1]

    if mode == "decode":
        xc, conv_state = _causal_conv(p, xin, cache["conv"])
        da, dbx, cmat = _ssm_inputs(cfg, p, xc)
        h = cache["ssm"].float() * da[:, 0] + dbx[:, 0]          # (B,di,N)
        y = torch.einsum("bin,bn->bi", h, cmat[:, 0])[:, None]
        new_cache = {"conv": conv_state.to(cache["conv"].dtype),
                     "ssm": h.to(cache["ssm"].dtype)}
    else:
        xc, conv_tail = _causal_conv(p, xin, None)
        y, h_last = _chunked_ssm(cfg, p, xc)
        new_cache = None
        if mode == "prefill":
            new_cache = {"conv": conv_tail.to(torch.bfloat16),
                         "ssm": h_last.to(torch.bfloat16)}
    y = y + xc.float() * p["d_skip"]
    y = (y * F.silu(z.float())).to(x.dtype)
    return einsum("bsi,id->bsd", y, p["out_proj"]), new_cache


def _chunked_ssm(cfg, p, xc):
    """Chunked selective scan. xc: (B,S,di) post-conv. -> y (B,S,di) fp32,
    final state (B,di,N) fp32."""
    b, s, di = xc.shape
    n = cfg.ssm_state
    c = min(CHUNK, s)
    assert s % c == 0, (s, c)
    h0 = torch.zeros((b, di, n), dtype=torch.float32, device=xc.device)
    ys = []
    for ci in range(s // c):
        y, h0 = _ssm_chunk(cfg, p, xc[:, ci * c:(ci + 1) * c], h0)
        ys.append(y)
    return torch.cat(ys, dim=1), h0


@repeated
def _ssm_chunk(cfg, p, xcc, h0):
    """One chunk of the selective scan from state ``h0``: (y (B,c,di)
    fp32, the state after the chunk)."""
    da, dbx, cmat = _ssm_inputs(cfg, p, xcc)
    a_cum, b_cum = linear_scan(da, dbx)
    h = constrain(a_cum * h0[:, None] + b_cum,
                  "batch", None, "ssm_inner", None)              # (B,c,di,N)
    y = constrain(torch.einsum("bsin,bsn->bsi", h, cmat),
                  "batch", None, "ssm_inner")                    # (B,c,di)
    return y, h[:, -1]


def ssm_cache_shape(cfg: ModelConfig, batch: int):
    di = cfg.ssm_expand * cfg.d_model
    return {"conv": (batch, cfg.ssm_conv - 1, di),
            "ssm": (batch, di, cfg.ssm_state)}


def ssm_cache_axes():
    """Logical axes of the O(1) recurrent SSM state (the stack prepends
    its "layers" axis). No ``kv_seq`` axis: slot streaming admits these
    leaves as whole-row overwrites."""
    return {"conv": ("batch", None, "ssm_inner"),
            "ssm": ("batch", "ssm_inner", "ssm_state")}


# ---------------------------------------------------------------------------
# Mamba-2 (the port's own, family ``hybrid_moe``: Granite-4.0-H)
# ---------------------------------------------------------------------------
#
# A scalar decay per head, B and C shared over a group of heads, the conv
# over x, B and C together, a gated RMSNorm before ``out_proj``
# (``GraniteMoeHybridMambaLayer``). Per head h, channel p and state n:
#
#   h[t] = exp(dt[t] A) h[t-1] + dt[t] x[t, p] B[t, n]
#   y[t, p] = sum_n C[t, n] h[t, p, n] + D x[t, p]
#
# Prefill runs the SSD chunked form, which keeps one state per chunk
# boundary and never one per position; decode runs the one-step
# recurrence on the resident state in f32.

def mamba2_dims(cfg) -> Tuple[int, int, int]:
    """(inner width, conv width over x, B and C, heads)."""
    di = cfg.ssm_expand * cfg.d_model
    return di, di + 2 * cfg.mamba_groups * cfg.ssm_state, cfg.mamba_heads


def mamba2_specs(cfg) -> Dict[str, Spec]:
    d = cfg.d_model
    di, cd, h = mamba2_dims(cfg)
    return {
        # z (di), xBC (cd) and dt (h), in the published order
        "in_proj": Spec((d, di + cd + h), ("embed", None)),
        "conv_w": Spec((cfg.ssm_conv, cd), ("conv", None)),
        "conv_b": Spec((cd,), (None,), init="zeros"),
        "dt_bias": Spec((h,), (None,), init="zeros", dtype=torch.float32),
        "a_log": Spec((h,), (None,), init="zeros", dtype=torch.float32),
        "d_skip": Spec((h,), (None,), init="ones", dtype=torch.float32),
        "norm": Spec((di,), ("ssm_inner",), init="ones"),
        "out_proj": Spec((di, d), ("ssm_inner", "embed")),
    }


def mamba2_cache_shape(cfg, batch: int):
    _, cd, h = mamba2_dims(cfg)
    return {"conv": (batch, cfg.ssm_conv - 1, cd),
            "state": (batch, h, cfg.mamba_head_dim, cfg.ssm_state)}


def mamba2_cache_axes():
    """Logical axes of the Mamba-2 row state (the stack prepends its
    "layers" axis); no ``kv_seq`` axis, so a slot admits it whole."""
    return {"conv": ("batch", None, None),
            "state": ("batch", None, None, None)}


def _conv_bias(p, xbc, conv_state):
    """The causal depthwise conv with bias over xBC (B,S,cd), then SiLU,
    in f32; ``conv_state`` (B,K-1,cd) is the inputs before ``xbc`` (None:
    zeros). Returns the activations and the last K-1 inputs."""
    k = p["conv_w"].shape[0]
    if conv_state is None:
        conv_state = xbc.new_zeros((xbc.shape[0], k - 1, xbc.shape[2]))
    xp = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)
    w = p["conv_w"].float()
    out = p["conv_b"].float() + sum(xp[:, i:i + xbc.shape[1]].float() * w[i]
                                    for i in range(k))
    return F.silu(out), xp[:, xp.shape[1] - (k - 1):]


def _heads(t, groups: int, heads: int):
    """A group's (B,...,g,N) B or C repeated over its heads: (B,...,h,N)."""
    return t.repeat_interleave(heads // groups, dim=-2) if groups > 1 \
        else t.expand(*t.shape[:-2], heads, t.shape[-1])


def ssd_scan(x, dt, a, bm, cm, chunk: int):
    """The SSD chunked scan from a zero state. x (B,S,h,P), dt (B,S,h)
    f32, a (h,) f32, bm and cm (B,S,g,N), head i in group i // (h/g).
    Returns y (B,S,h,P) (no skip term) and the state after the last
    position (B,h,P,N), both in ``dt``'s dtype.

    Positions are padded to whole chunks with dt = 0, which leaves the
    state as it was (decay 1, input 0), so any length is taken and the
    final state is the last real position's. Within a chunk the output is
    C B^T masked by the decay between positions; across chunks one state
    per boundary is carried."""
    b, s, h, pd = x.shape
    g, n = bm.shape[-2:]
    k = h // g
    c = min(chunk, s)
    pad = (-s) % c
    if pad:
        x, bm, cm = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, bm, cm))
        dt = F.pad(dt, (0, 0, 0, pad))
    nc = (s + pad) // c
    bm = bm.to(dt.dtype).reshape(b, nc, c, g, n)
    cm = cm.to(dt.dtype).reshape(b, nc, c, g, n)
    dt = dt.reshape(b, nc, c, g, k)
    xdt = x.to(dt.dtype).reshape(b, nc, c, g, k, pd) * dt[..., None]
    cum = torch.cumsum(dt * a.reshape(g, k), dim=2)          # (B,nc,c,g,k)
    # within a chunk: position l reads position j <= l, decayed by
    # exp(cum[l] - cum[j])
    seg = cum.permute(0, 1, 3, 4, 2)                         # (B,nc,g,k,c)
    causal = torch.ones(c, c, dtype=torch.bool, device=x.device).tril()
    decay = (seg[..., :, None] - seg[..., None, :]).masked_fill_(
        ~causal, float("-inf")).exp_()                       # (..,c,c)
    decay.mul_(torch.einsum("bzlgn,bzjgn->bzglj", cm, bm)[:, :, :, None])
    y = torch.einsum("bzgklj,bzjgkp->bzlgkp", decay, xdt)
    # each chunk's own input, decayed to its end
    to_end = torch.exp(cum[:, :, -1:] - cum)                 # (B,nc,c,g,k)
    local = torch.einsum("bzjgk,bzjgkp,bzjgn->bzgkpn", to_end, xdt, bm)
    # one state per boundary: the state entering each chunk
    whole = torch.exp(cum[:, :, -1])                         # (B,nc,g,k)
    state = xdt.new_zeros((b, g, k, pd, n))
    entering = []
    for z in range(nc):
        entering.append(state)
        state = state * whole[:, z, ..., None, None] + local[:, z]
    entering = torch.stack(entering, 1)                      # (B,nc,g,k,P,N)
    y = y + torch.einsum("bzlgn,bzgkpn->bzlgkp", cm, entering) \
        * torch.exp(cum)[..., None]
    return y.reshape(b, nc * c, h, pd)[:, :s], state.reshape(b, h, pd, n)


def _mamba2_step(state, x, dt, a, bm, cm):
    """One decode step of the recurrence in f32 on the resident state
    (B,h,P,N): x (B,h,P), dt (B,h), bm and cm (B,g,N). Returns y (B,h,P)
    f32 and the new state in ``state``'s dtype; with recording on, counts
    the bytes of the state-shaped tensors it makes."""
    hs = state.to(torch.float32, copy=True)
    bh = _heads(bm.float(), bm.shape[-2], x.shape[1])
    ch = _heads(cm.float(), cm.shape[-2], x.shape[1])
    hs.mul_(torch.exp(dt * a)[..., None, None])
    hs.addcmul_((dt[..., None] * x.float())[..., None], bh[:, :, None, :])
    y = torch.einsum("bhpn,bhn->bhp", hs, ch)
    new = hs.to(state.dtype)
    if obs.on():
        obs.count("ssm.decode.work_bytes", hs.nbytes + new.nbytes)
    return y, new


def mamba2_apply(cfg, p, x: torch.Tensor, mode: str,
                 cache: Optional[dict]) -> Tuple[torch.Tensor, Optional[dict]]:
    """x: (B,S,d) -> (B,S,d). ``cache`` {"conv": (B,K-1,cd), "state":
    (B,h,P,N)} in decode; prefill returns it in ``COMPUTE_DTYPE``.

    Recorded by :mod:`repro_torch.obs` when on: spans ``ssm.conv``,
    ``ssm.scan`` (prefill's SSD) and ``ssm.update`` (decode's
    recurrence); counters ``ssm.<mode>.state_bytes`` (the recurrent state
    decode reads, or prefill hands to the cache) and
    ``ssm.decode.work_bytes``, from shapes."""
    b, s, _ = x.shape
    di, cd, h = mamba2_dims(cfg)
    g, n, pd = cfg.mamba_groups, cfg.ssm_state, cfg.mamba_head_dim
    z, xbc, dt = torch.split(einsum("bsd,de->bse", x, p["in_proj"]),
                             [di, cd, h], dim=-1)
    decode = mode == "decode"
    with obs.span("ssm.conv"):
        xbc, conv_tail = _conv_bias(p, xbc, cache["conv"] if decode
                                    else None)
    xs, bm, cm = torch.split(xbc, [di, g * n, g * n], dim=-1)
    xs = xs.reshape(b, s, h, pd)
    bm, cm = bm.reshape(b, s, g, n), cm.reshape(b, s, g, n)
    dt = F.softplus(dt.float() + p["dt_bias"])                # (B,S,h)
    a = -torch.exp(p["a_log"].float())
    new_cache = None
    if decode:
        with obs.span("ssm.update"):
            y, state = _mamba2_step(cache["state"], xs[:, 0], dt[:, 0], a,
                                    bm[:, 0], cm[:, 0])
        y = y[:, None]
        new_cache = {"conv": conv_tail.to(cache["conv"].dtype),
                     "state": state}
    else:
        with obs.span("ssm.scan"):
            y, state = ssd_scan(xs, dt, a, bm, cm, cfg.mamba_chunk)
        if mode == "prefill":
            dt_c = common.COMPUTE_DTYPE
            new_cache = {"conv": conv_tail.to(dt_c), "state": state.to(dt_c)}
    if new_cache is not None and obs.on():
        obs.count(f"ssm.{mode}.state_bytes",
                  sum(t.nbytes for t in new_cache.values()))
    y = y + xs * p["d_skip"][:, None]
    # the gated RMSNorm over the inner width, in f32
    y = y.reshape(b, s, di) * F.silu(z.float())
    y = y * torch.rsqrt(y.square().mean(-1, keepdim=True) + cfg.norm_eps)
    y = y.to(x.dtype) * p["norm"].to(x.dtype)
    return einsum("bsi,id->bsd", y, p["out_proj"]), new_cache
