"""Device mesh construction for multi-chip scaling.

The reference "scales" by fanning six fixed-IP hosts over TCP sockets
(SURVEY §2 parallelism table); the counterpart here is a
`jax.sharding.Mesh` with two axes:

* ``dp`` — data parallel over the ciphertext/gate batch (the analog of
  the reference's multi-client fan-out: every gate is independent);
* ``tp`` — tensor parallel over the external-product contraction
  (TRGSW rows x N), splitting both the bootstrapping key (memory) and
  the matmul work, with one psum per blind-rotation step across the
  devices (the analog the survey assigns to "NTT stage all-to-all").
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: F401


def make_mesh(n_devices: int | None = None, tp: int = 1,
              devices=None) -> Mesh:
    """Build a (dp, tp) mesh over the first n_devices devices."""
    devices = list(devices or jax.devices())
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"need {n} devices, have {len(devices)}")
    if n % tp:
        raise ValueError(f"n_devices {n} not divisible by tp {tp}")
    arr = np.array(devices[:n]).reshape(n // tp, tp)
    return Mesh(arr, axis_names=("dp", "tp"))
