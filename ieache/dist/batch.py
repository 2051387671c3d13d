"""Data-parallel placement for batched expression evaluation.

The evaluator (`ieache/circuits/evaluator.py`) is written over a
leading batch axis; every gate in the batch is independent (the
reference's parallelism is OpenMP sections over 2-4 independent gates,
`/root/reference/Cloud/cloud.c:27-41` — here the axis is thousands of
expressions wide).  That makes multi-chip scaling pure data
parallelism: shard every operand array over ``dp``, replicate the
evaluation keys, and XLA propagates the shardings through the fused
`lax.scan` circuits with **zero collectives** in the steady state.

This module is the placement layer: it does not change any compute
path — the same `CloudEvaluator` runs sharded or not, bit-identically
(`tests/test_dist.py::test_dp_sharded_evaluator_bit_exact`).
"""

from __future__ import annotations

import dataclasses

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ieache.boot.bootstrap import DeviceCloudKey
from ieache.circuits.evaluator import Operand


def replicate_cloud_key(dck: DeviceCloudKey, mesh: Mesh) -> DeviceCloudKey:
    """Replicate the evaluation key on every device of the mesh.

    The analog of the reference's cloud-key fan-out (C16/C20,
    `Keygen/dragonfly_public_keygen.py:656-687`): one broadcast instead
    of per-host TCP transfers.
    """
    rep = NamedSharding(mesh, P())
    return DeviceCloudKey(
        bk=jax.device_put(dck.bk, rep),
        ks_limbs=jax.device_put(dck.ks_limbs, rep),
        params=dck.params,
    )


def shard_operand(op: Operand, mesh: Mesh) -> Operand:
    """Shard an operand's batch axis over ``dp`` (other axes replicated)."""
    dp = mesh.shape["dp"]
    if op.batch % dp:
        raise ValueError(f"batch {op.batch} not divisible by dp={dp}")

    def put(x):
        spec = P("dp", *([None] * (x.ndim - 1)))
        return jax.device_put(x, NamedSharding(mesh, spec))

    return Operand(**{
        f.name: put(getattr(op, f.name)) for f in dataclasses.fields(Operand)
    })


def gather_operand(op: Operand) -> Operand:
    """Bring a sharded answer back to a single addressable array."""
    import numpy as np

    return Operand(**{
        f.name: np.asarray(getattr(op, f.name))
        for f in dataclasses.fields(Operand)
    })
