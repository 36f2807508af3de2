"""Distribution layer, single device.

The model code calls ``sharding.constrain`` on activations and reads the
serve scopes of ``collectives``. On one card there is no mesh, so each of
these is what the JAX package's is outside a mesh or scope: the identity,
a mesh axis of size 1, no activation transport, a bf16 cache. The train
step's int8 gradient quantizers run here in their single-device form
(``collectives.compressed_psum`` with ``axis_name=None``). Meshes,
sharding presets and the collectives across devices come with the
multi-GPU slice.
"""

from repro_torch.dist import collectives, sharding  # noqa: F401
from repro_torch.dist.sharding import constrain, mesh_axis_size  # noqa: F401
