"""Distribution layer, single device.

The model code calls ``sharding.constrain`` on activations and reads the
serve scopes of ``collectives``. On one card there is no mesh, so
``constrain`` is the identity and every mesh axis has size 1, as in the
JAX package outside a mesh. The quantizers run here in their
single-device form: the train step's int8 gradient transport
(``collectives.compressed_psum`` with ``axis_name=None``) and the serve
path's int8 activation gather, cache stream and resident int8 and f8
caches, whose round trips round the values as the reference's do on a
(1, 1) mesh. ``fanin`` is the reference's host-side admission arbiter.
Meshes, sharding presets and the collectives across devices come with
the multi-GPU slice.
"""

from repro_torch.dist import collectives, fanin, sharding  # noqa: F401
from repro_torch.dist.sharding import constrain, mesh_axis_size  # noqa: F401
