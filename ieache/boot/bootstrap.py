"""Gate bootstrapping pipeline: modswitch → blind rotate → extract → keyswitch.

Replacement for tfhe-lib's ``tfhe_bootstrap_FFT`` (the engine
behind every ``boots*`` gate the reference evaluates at
``/root/reference/Cloud/cloud.c:30-43``).  Batched over a leading gate
axis B; all stages jit-compile into one XLA program with the
blind-rotation scan in the middle.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ieache.lwe.types import CloudKeySet
from ieache.ops.blind_rotate import blind_rotate
from ieache.ops.keyswitch import keyswitch, pack_ks_limbs
from ieache.params import TFHEParams

#: torus encoding of a gate-bootstrapping bit (1/8)
MU = 1 << 29


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DeviceCloudKey:
    """Evaluation keys packed for the device kernels."""

    bk: jnp.ndarray        # int32 (n, rows, k+1, N)
    ks_limbs: jnp.ndarray  # int8  (TORUS_LIMBS, kN*t, n+1)
    params: TFHEParams

    def tree_flatten(self):
        return (self.bk, self.ks_limbs), self.params

    @classmethod
    def tree_unflatten(cls, params, children):
        return cls(children[0], children[1], params)


def pack_cloud_key(cloud: CloudKeySet) -> DeviceCloudKey:
    return DeviceCloudKey(
        bk=jnp.asarray(cloud.bk),
        ks_limbs=pack_ks_limbs(cloud.ks),
        params=cloud.params,
    )


def mod_switch_2n(x: jnp.ndarray, params: TFHEParams) -> jnp.ndarray:
    """Torus32 -> Z_{2N} with round-to-nearest: (B, ...) int32 in [0, 2N)."""
    shift = 32 - params.log2_2N
    v = x.astype(jnp.uint32) + (jnp.uint32(1) << (shift - 1))
    return ((v >> shift) & (2 * params.N - 1)).astype(jnp.int32)


def _rotated_test_vector(barb: jnp.ndarray, mu, params: TFHEParams):
    """b-polynomial of X^(2N-barb) · (mu, mu, ..., mu): (B, N) int32.

    Coefficient j of the rotated all-mu test vector is +mu when
    (j - t) mod 2N < N (t = 2N - barb), else -mu.
    """
    n = params.N
    t = (2 * n - barb) % (2 * n)                       # (B,)
    j = jnp.arange(n, dtype=jnp.int32)
    pos = (j[None, :] - t[:, None]) % (2 * n)          # (B, N)
    return jnp.where(pos < n, jnp.int32(mu), jnp.int32(-mu))


def sample_extract(acc: jnp.ndarray, params: TFHEParams) -> jnp.ndarray:
    """Extract coefficient 0: (B, k+1, N) -> LWE (B, kN+1) under K-flat.

    a[u*N + 0] = acc_u[0]; a[u*N + m] = -acc_u[N-m] (negacyclic wrap).
    """
    b_dim = acc.shape[0]
    k, n = params.k, params.N
    parts = []
    for u in range(k):
        au = jnp.concatenate(
            [acc[:, u, :1], -acc[:, u, :0:-1]], axis=-1
        )
        parts.append(au)
    a = jnp.concatenate(parts, axis=-1)                 # (B, kN)
    body = acc[:, k, 0][:, None]
    return jnp.concatenate([a, body], axis=-1).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("mu",))
def bootstrap_no_ks(
    lwe: jnp.ndarray, key: DeviceCloudKey, mu: int = MU
) -> jnp.ndarray:
    """(B, n+1) -> (B, kN+1): bootstrap without the final keyswitch."""
    p = key.params
    n = p.n
    a, b = lwe[:, :n], lwe[:, n]
    bara = mod_switch_2n(a, p)                          # (B, n)
    barb = mod_switch_2n(b, p)                          # (B,)

    acc0 = jnp.zeros((lwe.shape[0], p.k + 1, p.N), jnp.int32)
    acc0 = acc0.at[:, p.k, :].set(_rotated_test_vector(barb, mu, p))

    acc = blind_rotate(acc0, bara, key.bk, p)
    return sample_extract(acc, p)


@functools.partial(jax.jit, static_argnames=("mu",))
def bootstrap(
    lwe: jnp.ndarray, key: DeviceCloudKey, mu: int = MU
) -> jnp.ndarray:
    """Full gate bootstrap: (B, n+1) -> (B, n+1), result ≈ LWE(±mu)."""
    ext = bootstrap_no_ks(lwe, key, mu)
    return keyswitch(ext, key.ks_limbs, key.params)


def np_batch(x) -> np.ndarray:
    """Utility: host -> device int32 with a guaranteed batch axis."""
    x = jnp.asarray(np.asarray(x, np.int32))
    if x.ndim == 1:
        x = x[None, :]
    return x
