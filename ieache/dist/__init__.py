"""Multi-chip / multi-host scaling: meshes, sharded bootstrap, dp
placement, and the jax.distributed runtime.

Import submodules directly (``from ieache.dist import mesh``) —
this package intentionally has NO eager imports: `dist.multihost`
must be importable before any XLA backend initializes
(jax.distributed.initialize's requirement), and pulling `dist.shard`
here would transitively initialize the backend via the boot/core
module-level constants.
"""
