"""Multi-host runtime: ``jax.distributed``.

The reference distributes work over six fixed-IP hosts with raw TCP +
BER + ad-hoc acks (SURVEY §5.8); its counterpart here is the JAX
multi-controller runtime: every host runs the same program,
``jax.distributed.initialize`` wires them to a coordinator, and a
single global mesh spans all hosts' devices — the ``dp`` (batch) axis
crosses hosts while ``tp`` stays within one host.  The
key fan-out of C15/C16 becomes replication of the packed cloud key
into the global mesh; ciphertext batches move as host-local shards of
global arrays (no per-chunk acks — the runtime owns transport).

Tested without a cluster: `tests/test_multihost.py` spawns two OS
processes with two virtual CPU devices each (gloo collectives) and
runs the dp-sharded bootstrap across the 4 global devices.
"""

from __future__ import annotations

# NOTE: jax / multihost_utils are imported INSIDE each function —
# importing them at module level can initialize the XLA backend, and
# jax.distributed.initialize() must run before any backend init.


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, platform: str | None = None) -> None:
    """Join the multi-controller runtime.

    platform="cpu" selects the gloo collectives backend so multi-host
    runs work on CPU test rigs as on GPU hosts (where NCCL provides
    the collectives).
    """
    import jax

    if platform:
        jax.config.update("jax_platforms", platform)
    if platform == "cpu":
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(tp: int = 1):
    """(dp, tp) mesh over ALL hosts' devices (jax.devices() is global
    after initialize)."""
    import jax

    from ieache.dist import mesh as dmesh

    return dmesh.make_mesh(len(jax.devices()), tp=tp)


def shard_global_batch(x, mesh):
    """Host-local batch shard -> global dp-sharded array.

    Each process passes its local slice of the batch; the result is
    one global array whose leading axis is sharded over dp across all
    hosts (the multi-host analog of `dist.batch.shard_operand`)."""
    import jax.experimental.multihost_utils as mhu
    from jax.sharding import PartitionSpec as P

    spec = P("dp", *([None] * (x.ndim - 1)))
    return mhu.host_local_array_to_global_array(x, mesh, spec)


def replicate_global(x, mesh):
    """Replicate identical host-local data (e.g. the packed cloud key
    from a deterministic keygen) onto every device of the global mesh
    — the C15/C16 key fan-out as one collective placement."""
    import jax.experimental.multihost_utils as mhu
    from jax.sharding import PartitionSpec as P

    return mhu.host_local_array_to_global_array(x, mesh, P())


def to_host_local(garr, mesh):
    """Global dp-sharded array -> this host's local shard."""
    import jax.experimental.multihost_utils as mhu
    from jax.sharding import PartitionSpec as P

    spec = P("dp", *([None] * (garr.ndim - 1)))
    return mhu.global_array_to_host_local_array(garr, mesh, spec)


def replicate_cloud_key(dck, mesh):
    """DeviceCloudKey replicated across the global mesh."""
    from ieache.boot.bootstrap import DeviceCloudKey

    return DeviceCloudKey(
        bk=replicate_global(dck.bk, mesh),
        ks_limbs=replicate_global(dck.ks_limbs, mesh),
        params=dck.params,
    )
