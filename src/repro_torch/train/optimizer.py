"""AdamW with f32 moments over (possibly bf16) parameters.

The port of ``src/repro/train/optimizer.py``, with the reference's
arithmetic written out (not ``torch.optim.AdamW``, whose eps sits outside
the bias correction and whose decay is a separate multiply): the
global-norm clip, ``sqrt(v / bc2) + eps``, and ``weight_decay * p`` folded
into the step. A bf16 parameter is updated in f32 and rounded back; there
is no f32 master copy. ``step`` is an int32 scalar tensor on the
parameters' device. The int8 error-feedback transport carries its
per-leaf residual in the state under ``"ef"``: ``init_state``,
``abstract_state`` (the state's ``TensorSpec``s, for the dry run) and
``state_axes`` grow it when ``error_feedback=True``, and
``apply_updates`` passes it through untouched (the train step owns it).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.common import (TensorSpec, tree_leaves, tree_map,
                                       tree_unzip)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


def _f32(v: float) -> float:
    """A Python float rounded to f32, as a jitted constant is."""
    return float(np.float32(v))


# glibc's cosf (sysdeps/ieee754/flt-32/s_cosf.c, __sincosf_table), which
# XLA's f32 cosine on the CPU calls: the quadrant by a product with 2/pi
# scaled by 2^24, then a polynomial in f64, rounded once to f32
_H = float.fromhex
_HPI_INV_2P24 = _H("0x1.45f306dc9c883p+23")
_HPI = _H("0x1.921fb54442d18p+0")
_COS_C = (1.0, _H("-0x1.ffffffd0c621cp-2"), _H("0x1.55553e1068f19p-5"),
          _H("-0x1.6c087e89a359dp-10"), _H("0x1.99343027bf8c3p-16"))
_COS_S = (_H("-0x1.555545995a603p-3"), _H("0x1.1107605230bc4p-7"),
          _H("-0x1.994eb3774cf24p-13"))


def _cosf(y: torch.Tensor) -> torch.Tensor:
    """f32 cosine of ``y`` (f32, |y| < 120) as glibc's ``cosf`` computes
    it, on any device: the same reduction and polynomials in f64. (glibc's
    shortcuts for |y| < 0.75 and |y| < 2^-12 give what the general path
    gives there: quadrant 0, and 1.0.)"""
    x = y.double()
    n = torch.floor((torch.trunc(x * _HPI_INV_2P24) + 2.0 ** 23) * 2.0 ** -24)
    r = x - n * _HPI
    quad = n.long() & 3
    # quadrants 1, 2 negate sin's argument; quadrants 2, 3 negate cos
    xs = torch.where((quad == 1) | (quad == 2), -r, r)
    csign = torch.where(quad >= 2, -1.0, 1.0).double()
    r2 = r * r
    r4 = r2 * r2
    c1 = csign * _COS_C[0] + r2 * (csign * _COS_C[1])
    c2 = csign * _COS_C[3] + r2 * (csign * _COS_C[4])
    cos = c1 + r4 * (csign * _COS_C[2]) + (r4 * r2) * c2
    x3 = xs * r2
    sin = xs + x3 * _COS_S[0] + (x3 * r2) * (_COS_S[1] + r2 * _COS_S[2])
    return torch.where((quad & 1) == 1, sin, cos).float()


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then a cosine decay to 0.1 x ``lr``; f32 on
    ``step``'s device. The reference's value as jitted XLA computes it on
    the CPU: each division by a constant as a product with its f32
    reciprocal, ``0.9 * 0.5`` folded, ``0.45 * (1 + cos) + 0.1`` fused
    into one rounding, and glibc's ``cosf``."""
    s = step.float()
    warm = torch.clamp(s * _f32(1.0 / max(cfg.warmup_steps, 1)), max=1.0)
    prog = torch.clamp(
        (s - cfg.warmup_steps)
        * _f32(1.0 / max(cfg.total_steps - cfg.warmup_steps, 1)), 0.0, 1.0)
    cos = _cosf(prog * _f32(np.pi))
    # (1 + cos) * 0.45 + 0.1 with one rounding: the product is exact in f64
    inner = ((cos + 1.0).double() * _f32(0.9 * 0.5) + _f32(0.1)).float()
    return (warm * _f32(cfg.lr)) * inner


def _ef_shape(p: torch.Tensor, ef_devices: Optional[int]) -> Tuple[int, ...]:
    # the data-parallel transport carries one residual per device; the
    # single-device step a single parameter-shaped one
    return tuple(p.shape) if ef_devices is None \
        else (ef_devices,) + tuple(p.shape)


def init_state(params, error_feedback: bool = False,
               ef_devices: Optional[int] = None) -> Dict[str, Any]:
    """Zero f32 moments (and residual) beside each parameter, laid out as
    the parameter (a DTensor parameter gets DTensor moments of its
    placements), and an int32 ``step`` of 0 on the parameters' device."""
    def f32(p):
        return torch.zeros_like(p, dtype=torch.float32)

    device = tree_leaves(params)[0].device
    state = {"mu": tree_map(f32, params), "nu": tree_map(f32, params),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    if error_feedback:
        state["ef"] = tree_map(
            lambda p: f32(p) if ef_devices is None else torch.zeros(
                _ef_shape(p, ef_devices), dtype=torch.float32,
                device=p.device),
            params)
    return state


def abstract_state(abstract_params, error_feedback: bool = False,
                   ef_devices: Optional[int] = None) -> Dict[str, Any]:
    """The state's ``TensorSpec``s for parameters of ``abstract_params``'
    shapes: f32 moments, an int32 ``step`` and, with ``error_feedback``,
    the f32 residual of ``_ef_shape``."""
    def f32(p):
        return TensorSpec(tuple(p.shape), torch.float32)

    def is_spec(x):
        return isinstance(x, TensorSpec)

    state = {"mu": tree_map(f32, abstract_params, is_leaf=is_spec),
             "nu": tree_map(f32, abstract_params, is_leaf=is_spec),
             "step": TensorSpec((), torch.int32)}
    if error_feedback:
        state["ef"] = tree_map(
            lambda p: TensorSpec(_ef_shape(p, ef_devices), torch.float32),
            abstract_params, is_leaf=is_spec)
    return state


def state_axes(param_axes_tree, error_feedback: bool = False
               ) -> Dict[str, Any]:
    axes = {"mu": param_axes_tree, "nu": param_axes_tree, "step": ()}
    if error_feedback:
        axes["ef"] = param_axes_tree   # residual laid out like the params
    return axes


def global_norm(tree) -> torch.Tensor:
    sq = sum(torch.sum(torch.square(g.float())) for g in tree_leaves(tree))
    return torch.sqrt(sq)


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state
                  ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step. ``grads`` may be bf16 (the transport's dtype); the
    math is f32. Returns new trees; the inputs are not modified."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = lr_schedule(cfg, step)
    b1c = 1 - torch.pow(_f32(cfg.b1), step.float())
    b2c = 1 - torch.pow(_f32(cfg.b2), step.float())

    def upd(p, g, mu, nu):
        g = g.float() * scale
        mu = cfg.b1 * mu + (1 - cfg.b1) * g
        nu = cfg.b2 * nu + (1 - cfg.b2) * torch.square(g)
        delta = (mu / b1c) / (torch.sqrt(nu / b2c) + cfg.eps) \
            + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), mu, nu

    new_p, new_mu, new_nu = tree_unzip(
        tree_map(upd, params, grads, state["mu"], state["nu"]), 3)
    metrics = {"grad_norm": gnorm, "lr": lr}
    # extra entries (the "ef" transport residual) ride through untouched
    new_state = dict(state)
    new_state.update({"mu": new_mu, "nu": new_nu, "step": step})
    return new_p, new_state, metrics
