"""LWE-to-LWE keyswitch as a single int8 matmul.

After sample extraction the ciphertext lives under the kN-dimensional
TRLWE coefficient key; this switches it back to the n-dimensional LWE
key (tfhe-lib's ``lweKeySwitch``, run inside every gate of the
reference at ``/root/reference/Cloud/cloud.c:30-43``).

We use the *linear* keyswitch variant: the key encrypts
``s_ext[i] * 2^(32-(j+1) basebit)`` per (i, j) (see
ieache/lwe/keygen.py), so

    out = (0, ..., b)  -  Digits(a) @ KS

with Digits in [-B/2, B/2) — one (B, kN*t) x (kN*t, n+1) matmul,
executed per int8 torus limb of KS and recombined with wrapping
shifts (exact mod 2^32).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ieache.core.poly import TORUS_LIMBS, split_i8_limbs
from ieache.ops.decompose import gadget_decompose
from ieache.params import TFHEParams


def pack_ks_limbs(ks: np.ndarray) -> jnp.ndarray:
    """Host KS matrix (K, n+1) int32 -> device (TORUS_LIMBS, K, n+1) int8."""
    return jnp.moveaxis(split_i8_limbs(jnp.asarray(ks)), -1, 0)


def keyswitch(
    lwe_ext: jnp.ndarray, ks_limbs: jnp.ndarray, params: TFHEParams
) -> jnp.ndarray:
    """(B, kN+1) int32 -> (B, n+1) int32 under the small LWE key."""
    b_dim = lwe_ext.shape[0]
    kn, t, n = params.kN, params.ks_t, params.n
    a = lwe_ext[:, :kn]
    body = lwe_ext[:, kn]

    digits = gadget_decompose(a, params.ks_basebit, t)   # (B, kN, t)
    d8 = digits.reshape(b_dim, kn * t).astype(jnp.int8)

    acc = jnp.zeros((b_dim, n + 1), jnp.int32)
    for v in range(TORUS_LIMBS):
        part = jax.lax.dot_general(
            d8, ks_limbs[v],
            dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32,
        )
        acc = acc + (part << (8 * v))

    out = -acc
    out = out.at[:, n].add(body)
    return out
