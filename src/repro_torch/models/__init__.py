"""Model code of the port: the training math of all seven families.

``transformer.forward(cfg, params, batch)`` computes the loss and its
metrics on a tree of tensors laid out as the reference's
(``src/repro/models/``), so ``interop.params_from_jax`` carries the
reference's weights across leaf for leaf.
"""

from repro_torch.models.interop import params_from_jax  # noqa: F401
from repro_torch.models.transformer import (  # noqa: F401
    TransformerLM,
    forward,
    init_params,
    param_specs,
)
