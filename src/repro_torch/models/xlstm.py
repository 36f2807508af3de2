"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel training form) and
sLSTM (scalar memory, exact recurrent scan), per arXiv:2405.04517.

The port of ``src/repro/models/xlstm.py``. Block-diagonal (per-head)
q/k/v and recurrent projections follow the official block design. All
recurrences are numerically stabilized with a running max state m. Decode
state is O(1) per token: the mLSTM's C, n, m and conv tail, the sLSTM's
h, c, n, m.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs import ModelConfig
from repro_torch.models import common
from repro_torch.models.common import Spec, einsum, repeated

CHUNK = 256
NEG = -1e30


def _logsig(x):
    return -F.softplus(-x)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_specs(cfg: ModelConfig) -> Dict[str, Spec]:
    d = cfg.d_model
    di = int(cfg.proj_factor_mlstm * d)
    h = cfg.n_heads
    dh = di // h
    return {
        "ln": Spec((d,), ("embed",), init="ones"),
        "w_up": Spec((d, 2, di), ("embed", None, "ssm_inner")),
        "conv_w": Spec((4, di), ("conv", "ssm_inner")),
        "wq": Spec((h, dh, dh), ("heads", "head_dim", None)),
        "wk": Spec((h, dh, dh), ("heads", "head_dim", None)),
        "wv": Spec((h, dh, dh), ("heads", "head_dim", None)),
        "w_i": Spec((di, h), ("ssm_inner", "heads"), init="small"),
        "w_f": Spec((di, h), ("ssm_inner", "heads"), init="small"),
        "b_i": Spec((h,), ("heads",), init="zeros"),
        "b_f": Spec((h,), ("heads",), init="ones"),
        "out_norm": Spec((di,), ("ssm_inner",), init="ones"),
        "w_down": Spec((di, d), ("ssm_inner", "embed")),
    }


def _mlstm_qkvif(cfg, p, x_conv, x_raw):
    """Per-head projections. x_*: (B,S,di). Returns q,k,v (B,S,H,dh); i,f (B,S,H)."""
    h = cfg.n_heads
    b, s, di = x_conv.shape
    dh = di // h
    xch = x_conv.reshape(b, s, h, dh)
    xrh = x_raw.reshape(b, s, h, dh)
    q = einsum("bshd,hde->bshe", xch, p["wq"])
    # the reference divides by a numpy f64 scalar, which JAX promotes to f32
    k = einsum("bshd,hde->bshe", xch, p["wk"]).float() / np.sqrt(dh)
    v = einsum("bshd,hde->bshe", xrh, p["wv"])
    i = einsum("bsi,ih->bsh", x_raw, p["w_i"]).float() + p["b_i"].float()
    f = einsum("bsi,ih->bsh", x_raw, p["w_f"]).float() + p["b_f"].float()
    return q, k, v, i, f


@repeated
def _mlstm_chunk(carry, blk):
    """One chunk of the stabilized chunkwise mLSTM.

    carry: C (B,H,dh,dh), n (B,H,dh), m (B,H)  [true state = exp(m) * C]
    blk: q,k,v (B,c,H,dh) ; i,f (B,c,H)
    """
    C, n, m = carry
    q, k, v, i, f = blk
    qf, kf, vf = q.float(), k.float(), v.float()
    c = q.shape[1]
    logf = _logsig(f)                                            # (B,c,H)
    b_cum = torch.cumsum(logf, dim=1)                            # (B,c,H)
    # D[t,s] = b_t - b_s + i_s   for s <= t
    D = b_cum[:, :, None] - b_cum[:, None, :] + i[:, None, :]    # (B,t,s,H)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
    D = torch.where(tri[None, :, :, None], D, NEG)
    m_intra = torch.amax(D, dim=2)                               # (B,t,H)
    m_inter = b_cum + m[:, None]                                 # (B,t,H)
    m_t = torch.maximum(m_intra, m_inter)
    w = torch.exp(D - m_t[:, :, None, :])                        # (B,t,s,H)
    scores = einsum("bthd,bshd->btsh", qf, kf)                   # (B,t,s,H)
    y_intra = einsum("btsh,btsh,bshd->bthd", w, scores, vf)
    inter_scale = torch.exp(m_inter - m_t)                       # (B,t,H)
    y_inter = einsum("bthd,bhde->bthe", qf, C) * inter_scale[..., None]
    n_t = einsum("btsh,bshd->bthd", w, kf) \
        + n[:, None] * inter_scale[..., None]                    # (B,t,H,dh)
    denom = torch.maximum(torch.abs(einsum("bthd,bthd->bth", n_t, qf)),
                          torch.exp(-m_t))
    y = (y_intra + y_inter) / denom[..., None]                   # (B,t,H,dh)
    # ---- state update to end of chunk ----
    b_last = b_cum[:, -1]                                        # (B,H)
    dec = b_last[:, None] - b_cum + i                            # (B,s,H)
    m_new = torch.maximum(b_last + m, torch.amax(dec, dim=1))    # (B,H)
    wC = torch.exp(dec - m_new[:, None])                         # (B,s,H)
    # C stored k-major: C[d, e] = sum_s decay_s * k_s[d] * v_s[e], so queries
    # contract over the k dimension (first index)
    C_new = C * torch.exp(b_last + m - m_new)[..., None, None] \
        + einsum("bsh,bshd,bshe->bhde", wC, kf, vf)
    n_new = n * torch.exp(b_last + m - m_new)[..., None] \
        + einsum("bsh,bshd->bhd", wC, kf)
    return (C_new, n_new, m_new), y


@repeated
def mlstm_apply(cfg: ModelConfig, p, x, mode: str, cache: Optional[dict]
                ) -> Tuple[torch.Tensor, Optional[dict]]:
    b, s, d = x.shape
    hh = cfg.n_heads
    di = int(cfg.proj_factor_mlstm * d)
    dh = di // hh
    xn = common.rms_norm(x, p["ln"], cfg.norm_eps)
    proj = einsum("bsd,dzi->bszi", xn, p["w_up"])
    xm, z = proj[:, :, 0], proj[:, :, 1]
    # causal conv (kernel 4) on the mlstm branch; decode carries the tail
    k4 = p["conv_w"].shape[0]
    if mode == "decode" and cache is not None:
        pad = cache["conv"].to(xm.dtype)
    else:
        pad = torch.zeros((b, k4 - 1, di), dtype=xm.dtype, device=x.device)
    xp = torch.cat([pad, xm], dim=1)
    conv_tail = xp[:, -(k4 - 1):]
    xc = F.silu(sum(xp[:, i:i + s] * p["conv_w"][i] for i in range(k4)))
    q, k, v, i_pre, f_pre = _mlstm_qkvif(cfg, p, xc, xm)

    if mode == "decode":
        C, n, m = cache["C"].float(), cache["n"].float(), cache["m"].float()
        logf = _logsig(f_pre[:, 0])
        m_new = torch.maximum(logf + m, i_pre[:, 0])
        fs = torch.exp(logf + m - m_new)[..., None, None]
        is_ = torch.exp(i_pre[:, 0] - m_new)[..., None, None]
        kf = k[:, 0].float()
        vf = v[:, 0].float()
        C_new = fs * C + is_ * einsum("bhd,bhe->bhde", kf, vf)
        n_new = fs[..., 0] * n + is_[..., 0] * kf
        qf = q[:, 0].float()
        num = einsum("bhd,bhde->bhe", qf, C_new)
        den = torch.maximum(torch.abs(einsum("bhd,bhd->bh", n_new, qf)),
                            torch.exp(-m_new))
        y = (num / den[..., None])[:, None]                      # (B,1,H,dh)
        new_cache = {"C": C_new.to(cache["C"].dtype),
                     "n": n_new.to(cache["n"].dtype),
                     "m": m_new.to(cache["m"].dtype),
                     "conv": conv_tail.to(cache["conv"].dtype)}
    else:
        c = min(CHUNK, s)
        assert s % c == 0
        dev = x.device
        carry = (torch.zeros((b, hh, dh, dh), dtype=torch.float32, device=dev),
                 torch.zeros((b, hh, dh), dtype=torch.float32, device=dev),
                 torch.zeros((b, hh), dtype=torch.float32, device=dev))
        ys = []
        for ci in range(s // c):
            sl = slice(ci * c, (ci + 1) * c)
            carry, y = _mlstm_chunk(carry, tuple(t[:, sl] for t in
                                                 (q, k, v, i_pre, f_pre)))
            ys.append(y)
        y = torch.cat(ys, dim=1)
        new_cache = None
        if mode == "prefill":
            new_cache = {"C": carry[0].float(), "n": carry[1].float(),
                         "m": carry[2].float(),
                         "conv": conv_tail.to(torch.bfloat16)}
    y = y.reshape(b, -1, di).to(x.dtype)
    y = common.rms_norm(y, p["out_norm"], cfg.norm_eps)
    y = y * F.silu(z)
    return x + einsum("bsi,id->bsd", y, p["w_down"]), new_cache


def mlstm_cache_shape(cfg: ModelConfig, batch: int):
    di = int(cfg.proj_factor_mlstm * cfg.d_model)
    h = cfg.n_heads
    dh = di // h
    return {"C": (batch, h, dh, dh), "n": (batch, h, dh), "m": (batch, h),
            "conv": (batch, 3, di)}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_specs(cfg: ModelConfig) -> Dict[str, Spec]:
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    ff = int(cfg.proj_factor_slstm * d)
    return {
        "ln": Spec((d,), ("embed",), init="ones"),
        "w_gates": Spec((d, 4, d), ("embed", None, None)),        # z,i,f,o
        "r_gates": Spec((4, h, dh, dh), (None, "heads", "head_dim", None),
                        init="small"),
        "b_gates": Spec((4, d), (None, None), init="zeros"),
        "ln_ff": Spec((d,), ("embed",), init="ones"),
        "ff_gate": Spec((d, ff), ("embed", "mlp")),
        "ff_up": Spec((d, ff), ("embed", "mlp")),
        "ff_down": Spec((ff, d), ("mlp", "embed")),
    }


def _slstm_pre(n_heads, r_gates, b_gates, x_t, h_prev):
    """Gate pre-activations: W x (precomputed) + R h_{t-1} + b. -> (4,B,d)."""
    b = x_t.shape[0]
    d = h_prev.shape[-1]
    hp = h_prev.reshape(b, n_heads, d // n_heads)
    rec = einsum("ghde,bhd->gbhe", r_gates.float(),
                 hp.float()).reshape(4, b, d)
    return x_t.float().transpose(0, 1) + rec + b_gates.float()[:, None]


def _slstm_post(pre, state):
    """State update given pre-activations. pre: (4,B,d)."""
    _, c_prev, n_prev, m_prev = state
    z = torch.tanh(pre[0])
    logf = _logsig(pre[2])
    m_t = torch.maximum(logf + m_prev, pre[1])
    f_s = torch.exp(logf + m_prev - m_t)
    i_s = torch.exp(pre[1] - m_t)
    c_t = f_s * c_prev + i_s * z
    n_t = f_s * n_prev + i_s
    h_t = torch.sigmoid(pre[3]) * c_t / torch.clamp_min(n_t, 1e-6)
    return h_t, c_t, n_t, m_t


@repeated
def _slstm_cell_raw(n_heads, r_gates, b_gates, x_t, state):
    """One sLSTM step. x_t: (B,4,d) pre-projected gates; state: 4x (B,d)."""
    pre = _slstm_pre(n_heads, r_gates, b_gates, x_t, state[0])
    return _slstm_post(pre, state)


# ---------------------------------------------------------------------------
# sLSTM sequence with deferred recurrent-weight-grad reduction.
#
# The reference's custom VJP (``_slstm_seq_fwd``/``_slstm_seq_bwd``) as an
# autograd.Function: forward saves the state sequence; backward runs the
# reverse per-step scan for d_pre alone, then contracts dR and db once over
# (S, B) -- on a sharded batch, one reduction after the loop instead of one
# per timestep.
# ---------------------------------------------------------------------------

class _SLSTMSequence(torch.autograd.Function):

    @staticmethod
    def forward(ctx, n_heads, r_gates, b_gates, gates_x, h0, c0, n0, m0):
        state0 = (h0, c0, n0, m0)
        state = state0
        seq = []
        for t in range(gates_x.shape[0]):
            state = _slstm_cell_raw(n_heads, r_gates, b_gates, gates_x[t],
                                    state)
            seq.append(state)
        states_seq = tuple(torch.stack(xs) for xs in zip(*seq))  # 4x (S,B,d)
        ctx.n_heads = n_heads
        ctx.save_for_backward(r_gates, b_gates, gates_x, *state0, *states_seq)
        return (states_seq[0],) + tuple(x[-1].clone() for x in states_seq)

    @staticmethod
    def backward(ctx, g_ys, *g_final):
        n_heads = ctx.n_heads
        saved = ctx.saved_tensors
        r_gates, b_gates, gates_x = saved[:3]
        state0, states_seq = saved[3:7], saved[7:]
        s, bsz, d = gates_x.shape[0], gates_x.shape[1], gates_x.shape[-1]
        dh = d // n_heads
        rf = r_gates.float()

        d_state = tuple(g_final)
        d_pres = [None] * s
        for t in range(s - 1, -1, -1):
            sp = state0 if t == 0 else tuple(x[t - 1] for x in states_seq)
            d_pres[t], d_state = _slstm_step_back(
                n_heads, r_gates, b_gates, rf, gates_x[t], sp, d_state,
                g_ys[t])
        d_pre_seq = torch.stack(d_pres)                   # (S,4,B,d)

        # deferred weight-grad contractions: ONE reduction over (S, B)
        h_prev_seq = torch.cat([state0[0][None], states_seq[0][:-1]], dim=0)
        hps = h_prev_seq.reshape(s, bsz, n_heads, dh)
        dps = d_pre_seq.reshape(s, 4, bsz, n_heads, dh)
        dR = torch.einsum("sgbhe,sbhd->ghde", dps, hps.float())
        db = torch.sum(d_pre_seq, dim=(0, 2))             # (4,d)
        dxs = d_pre_seq.transpose(1, 2)                   # (S,B,4,d)
        return (None, dR.to(r_gates.dtype), db.to(b_gates.dtype),
                dxs.to(gates_x.dtype)) + d_state


@repeated
def _slstm_step_back(n_heads, r_gates, b_gates, rf, x_t, sp, d_state, g_y):
    """One step of the reverse scan: the gradient at step t's output
    (``d_state`` plus ``g_y``) back to its pre-activations and its input
    state. Returns ``(d_pre, d_state_prev)``."""
    bsz, d = sp[0].shape
    dh = d // n_heads
    d_state = (d_state[0] + g_y,) + tuple(d_state[1:])
    pre = _slstm_pre(n_heads, r_gates, b_gates, x_t, sp[0])
    with torch.enable_grad():
        pre = pre.detach().requires_grad_()
        sp_in = tuple(x.detach().requires_grad_() for x in sp)
        out = _slstm_post(pre, sp_in)
        d_pre, *d_prev = torch.autograd.grad(
            out, (pre,) + sp_in, d_state, allow_unused=True)
    # h_{t-1} feeds the recurrence only: dh = R^T d_pre
    dpg = d_pre.reshape(4, bsz, n_heads, dh)
    dh_prev = torch.einsum("ghde,gbhe->bhd", rf, dpg).reshape(bsz, d)
    d_state = (dh_prev,) + tuple(
        torch.zeros_like(x) if g is None else g
        for x, g in zip(sp_in[1:], d_prev[1:]))
    return d_pre, d_state


def _slstm_sequence(n_heads, r_gates, b_gates, gates_x, state0):
    """gates_x: (S, B, 4, d). Returns (ys (S,B,d), final state)."""
    ys, *final = _SLSTMSequence.apply(n_heads, r_gates, b_gates, gates_x,
                                      *state0)
    return ys, tuple(final)


@repeated
def slstm_apply(cfg: ModelConfig, p, x, mode: str, cache: Optional[dict]
                ) -> Tuple[torch.Tensor, Optional[dict]]:
    b, s, d = x.shape
    xn = common.rms_norm(x, p["ln"], cfg.norm_eps)
    gates_in = einsum("bsd,dge->bsge", xn, p["w_gates"])         # (B,S,4,d)
    if cache is not None and mode == "decode":
        state = (cache["h"].float(), cache["c"].float(),
                 cache["n"].float(), cache["m"].float())
        h_t, c_t, n_t, m_t = _slstm_cell_raw(cfg.n_heads, p["r_gates"],
                                             p["b_gates"], gates_in[:, 0],
                                             state)
        ys = h_t[:, None]
        new_cache = {"h": h_t.to(cache["h"].dtype),
                     "c": c_t.to(cache["c"].dtype),
                     "n": n_t.to(cache["n"].dtype),
                     "m": m_t.to(cache["m"].dtype)}
    else:
        zeros = torch.zeros((b, d), dtype=torch.float32, device=x.device)
        state0 = (zeros, zeros, zeros, zeros)
        ys, state = _slstm_sequence(cfg.n_heads, p["r_gates"], p["b_gates"],
                                    gates_in.transpose(0, 1), state0)
        ys = ys.transpose(0, 1)                                  # (B,S,d)
        new_cache = None
        if mode == "prefill":
            new_cache = {"h": state[0].float(), "c": state[1].float(),
                         "n": state[2].float(), "m": state[3].float()}
    x = x + ys.to(x.dtype)
    # post FFN (gated, pf ~4/3)
    xf = common.rms_norm(x, p["ln_ff"], cfg.norm_eps)
    ff = common.swiglu(xf, p["ff_gate"], p["ff_up"], p["ff_down"])
    return x + ff, new_cache


def slstm_cache_shape(cfg: ModelConfig, batch: int):
    d = cfg.d_model
    return {"h": (batch, d), "c": (batch, d), "n": (batch, d), "m": (batch, d)}


def is_mlstm_layer(cfg: ModelConfig, idx: int) -> bool:
    return idx % cfg.mlstm_every == 0
