"""Model code of the port: all seven families, training and serving.

``transformer.forward(cfg, params, batch, mode)`` computes the loss and its
metrics (``"train"``), or logits and a decode cache (``"encode"``,
``"prefill"``, ``"decode"``) on a tree of tensors laid out as the
reference's (``src/repro/models/``), so ``interop.params_from_jax`` and
``interop.cache_from_jax`` carry the reference's weights and caches
across leaf for leaf. ``registry`` holds the families' serve capabilities
and the decode-state stores.
"""

from repro_torch.models.interop import cache_from_jax, params_from_jax  # noqa: F401
from repro_torch.models.transformer import (  # noqa: F401
    TransformerLM,
    forward,
    init_params,
    param_specs,
)
