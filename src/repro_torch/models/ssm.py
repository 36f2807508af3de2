"""Selective SSM (Mamba-style) head used by the Hymba hybrid layer.

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

from repro_torch.configs import ModelConfig
from repro_torch.dist.sharding import constrain
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
