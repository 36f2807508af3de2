"""Assigned input-shape sets and their shape-and-dtype stand-ins.

The port of ``src/repro/configs/shapes.py``. Every (arch x shape) cell is
defined here; ``applicable()`` encodes the documented skips (encoder-only
archs have no decode step; full-attention archs skip long_500k).
``input_specs()`` returns ``TensorSpec``s (the port's
``jax.ShapeDtypeStruct``: a shape and a dtype, no data), so nothing is
allocated for the full-size configs. ``make_batch`` draws a batch of those
shapes from a ``torch.Generator``; its draws are not ``jax.random``'s.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.configs import ModelConfig
from repro_torch.models import transformer
from repro_torch.models.common import resolve_device
from repro_torch.models.transformer import TensorSpec


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str              # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int
    microbatches: int = 1  # train only: gradient-accumulation steps


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256, microbatches=8),
    "prefill_8k": ShapeSpec("prefill_8k", "prefill", 8_192, 64),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}

SHAPE_IDS = tuple(SHAPES)


def expand_shape_names(spec: str) -> Tuple[str, ...]:
    """Expand a comma list of shape names and/or kinds into shape names.

    ``"decode"`` -> every decode-kind shape, ``"prefill_8k,decode"`` ->
    that shape plus the decode shapes, ``"all"`` -> everything. Raises
    ``KeyError`` on an unknown token.
    """
    if spec == "all":
        return SHAPE_IDS
    out = []
    for tok in spec.split(","):
        if tok in SHAPES:
            out.append(tok)
        elif tok in ("train", "prefill", "decode"):
            out.extend(n for n, s in SHAPES.items() if s.kind == tok)
        else:
            raise KeyError(f"unknown shape or kind {tok!r}; "
                           f"known: {', '.join(SHAPE_IDS)} + train/prefill/decode")
    return tuple(dict.fromkeys(out))


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    if shape.kind == "decode" and not cfg.supports_decode:
        return False, "encoder-only arch: no decode step"
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: 524k decode needs sub-quadratic attention"
    return True, ""


def _sds(shape, dtype) -> TensorSpec:
    return TensorSpec(tuple(shape), dtype)


def batch_axes(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Logical axes for each batch leaf (for input shardings)."""
    ax: Dict[str, Any] = {}
    if shape.kind == "train":
        if cfg.frontend == "audio_frames":
            ax["frames"] = ("batch", "seq", None)
            ax["mask"] = ("batch", "seq")
        else:
            ax["tokens"] = ("batch", "seq")
        if cfg.frontend == "vit_patches":
            ax["patches"] = ("batch", None, None)
        ax["labels"] = ("batch", "seq")
    elif shape.kind == "prefill":
        if cfg.frontend == "audio_frames":
            ax["frames"] = ("batch", "seq", None)
        else:
            ax["tokens"] = ("batch", "seq")
        if cfg.frontend == "vit_patches":
            ax["patches"] = ("batch", None, None)
    else:  # decode
        ax["tokens"] = ("batch", None)
        ax["pos"] = ()
    return ax


def input_specs(cfg: ModelConfig, shape: ShapeSpec
                ) -> Tuple[Dict[str, Any], Optional[Any]]:
    """(batch TensorSpec dict, cache TensorSpec tree or None) for one cell."""
    ok, why = applicable(cfg, shape)
    if not ok:
        raise ValueError(f"{cfg.name} x {shape.name}: {why}")
    b, s = shape.global_batch, shape.seq_len
    batch: Dict[str, Any] = {}
    cache = None

    if shape.kind in ("train", "prefill"):
        if cfg.frontend == "audio_frames":
            batch["frames"] = _sds((b, s, transformer.AUDIO_HIDDEN),
                                   torch.bfloat16)
        elif cfg.frontend == "vit_patches":
            batch["tokens"] = _sds((b, s - cfg.n_vision_tokens), torch.int32)
            batch["patches"] = _sds((b, cfg.n_vision_tokens,
                                     transformer.VIT_HIDDEN), torch.bfloat16)
        else:
            batch["tokens"] = _sds((b, s), torch.int32)
        if shape.kind == "train":
            lab_len = s if cfg.frontend != "vit_patches" else s - cfg.n_vision_tokens
            batch["labels"] = _sds((b, lab_len), torch.int32)
            if cfg.frontend == "audio_frames":
                batch["mask"] = _sds((b, s), torch.bool)
    else:  # decode: one new token against a cache of seq_len
        batch["tokens"] = _sds((b, 1), torch.int32)
        batch["pos"] = _sds((), torch.int32)
        cache = transformer.abstract_cache(cfg, b, s)
    return batch, cache


def make_batch(cfg: ModelConfig, shape: ShapeSpec, gen: torch.Generator,
               device: Union[str, torch.device, None] = None
               ) -> Tuple[Dict[str, Any], Optional[Any]]:
    """A random batch matching ``input_specs`` and a zero cache (decode
    shapes), drawn from ``gen`` on the host in the leaves' sorted order
    and placed on the card unless ``device`` names another."""
    device = resolve_device(device, "make_batch")
    specs, cache = input_specs(cfg, shape)
    out = {}
    for name, sds in sorted(specs.items()):
        if sds.dtype == torch.int32 and name in ("tokens", "labels"):
            x = torch.randint(0, cfg.vocab, sds.shape, generator=gen,
                              dtype=torch.int32)
        elif sds.dtype == torch.int32:
            x = torch.full(sds.shape, shape.seq_len - 1, dtype=torch.int32)
        elif sds.dtype == torch.bool:
            x = torch.rand(sds.shape, generator=gen) < 0.3
        else:
            x = torch.randn(sds.shape, generator=gen).to(sds.dtype)
        out[name] = x.to(device)
    if cache is not None:
        cache = transformer.zeros_like_spec(cache, device)
    return out, cache
