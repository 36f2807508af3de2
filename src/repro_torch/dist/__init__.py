"""Distribution layer: sharding rules, collectives, ranks.

``sharding`` maps logical axes onto a ``DeviceMesh`` (the reference's
rules and presets) and ``constrain`` lays a DTensor out by them; outside
an ``axis_rules`` context it is the identity. ``collectives`` holds the
int8 gradient transport -- one device, or the two-stage exchange over a
mesh axis -- with every collective's bytes counted, and the serve path's
int8 activation gather, cache stream and resident int8 and f8 caches,
whose round trips round the values as the reference's do on a (1, 1)
mesh. ``spawn`` runs a group of ranks in spawned processes with a time
limit. ``fanin`` is the reference's host-side admission arbiter.
"""

from repro_torch.dist import collectives, fanin, sharding  # noqa: F401
from repro_torch.dist.sharding import constrain, mesh_axis_size  # noqa: F401
