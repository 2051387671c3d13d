"""Device-accelerated keyset generation — bit-identical to the host path.

The reference's keygen is a single-core CPU binary whose wall clock it
prints as a benchmark (``/root/reference/Keygen/keygen.c:53-56``); the
host NumPy path in :mod:`ieache.lwe.keygen` takes ~2 minutes at
λ=110 (threefry streams + int32 matmuls).  This module moves the heavy
parts onto the accelerator:

* all threefry streams via the jnp implementation (bit-exact with the
  NumPy spec — tests/test_prng.py);
* centered-binomial noise via `jax.lax.population_count`;
* the TRLWE body polynomials ``b = Σ a_u ⊛ K_u`` as int8-limb matmuls
  against the Toeplitz expansion of the (binary) TRLWE key;
* the keyswitch bodies ``b = a·s + msg + e`` as int8-limb matvecs.

`generate_secret_keyset_device` must produce arrays identical to the
host generator (tests/test_keygen_device.py).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ieache.core import poly
from ieache.lwe import keygen as host_kg
from ieache.lwe.types import (
    CloudKeySet, GateKeyPair, LweKey, SecretKeySet, TrlweKey,
)
from ieache.params import TFHEParams
from ieache.utils import prng
from ieache.utils.prng import _threefry2x32_core

_GOLDEN = np.uint32(0x9E3779B9)


def _jderive(keys, idx):
    """Vectorized derive over key arrays (jnp)."""
    k0, k1 = keys
    i = jnp.full_like(k0, idx) if np.isscalar(idx) else idx.astype(
        jnp.uint32
    )
    return _threefry2x32_core(
        k0, k1, i, jnp.full_like(k0, _GOLDEN), jnp
    )


def _jbits_multi(keys, n: int):
    """Per-stream words: keys (R,) -> uint32 (R, n), matches
    prng.random_bits_multi."""
    k0, k1 = keys
    nblocks = (n + 1) // 2
    ctr = jnp.arange(nblocks, dtype=jnp.uint32)[None, :]
    y0, y1 = _threefry2x32_core(
        k0[:, None], k1[:, None], ctr, jnp.zeros_like(ctr), jnp
    )
    out = jnp.stack([y0, y1], axis=-1).reshape(k0.shape[0], 2 * nblocks)
    return out[:, :n]


def _jbinomial_multi(keys, n: int, scale: int, noise_bits: int):
    if scale == 0:
        return jnp.zeros((keys[0].shape[0], n), jnp.int32)
    words_per = noise_bits // 32
    w = _jbits_multi(keys, n * words_per).reshape(
        keys[0].shape[0], n, words_per
    )
    pop = jnp.sum(
        jax.lax.population_count(w).astype(jnp.int32), axis=2
    )
    return (pop - noise_bits // 2) * jnp.int32(scale)


def _limb_matmul_i32(a32: jnp.ndarray, t8: jnp.ndarray) -> jnp.ndarray:
    """Exact (R, N) int32 @ (N, M) small-int matrix, mod 2^32."""
    limbs = poly.split_i8_limbs(a32)  # (R, N, 4)
    out = jnp.zeros((a32.shape[0], t8.shape[1]), jnp.int32)
    for v in range(poly.TORUS_LIMBS):
        part = jax.lax.dot_general(
            limbs[..., v], t8,
            dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32,
        )
        out = out + (part << (8 * v))
    return out


def generate_secret_keyset_device(
    params: TFHEParams, seed_words=host_kg.MAIN_SEED
) -> SecretKeySet:
    p = params
    master = prng.key_from_seed_words(seed_words)
    lwe_s = prng.uniform_bits01(prng.derive(master, 0), p.n)
    trlwe_k = prng.uniform_bits01(
        prng.derive(master, 1), p.k * p.N
    ).reshape(p.k, p.N)

    rows, n, big_n, k = p.trgsw_rows, p.n, p.N, p.k

    # ---- bootstrapping key ------------------------------------------------
    bk_root = prng.derive(master, 2)
    i_keys = prng.derive_multi(bk_root, np.arange(n))
    i_k0 = jnp.asarray(i_keys[0].astype(np.uint32))
    i_k1 = jnp.asarray(i_keys[1].astype(np.uint32))
    # derive(i, p) for all rows -> (n*rows,)
    row_keys = []
    for pr in range(rows):
        row_keys.append(_jderive((i_k0, i_k1), pr))
    rk0 = jnp.stack([r[0] for r in row_keys], 1).reshape(-1)
    rk1 = jnp.stack([r[1] for r in row_keys], 1).reshape(-1)

    masks = []
    for u in range(k):
        mk = _jderive((rk0, rk1), u)
        masks.append(_jbits_multi(mk, big_n).astype(jnp.int32))
    nk = _jderive((rk0, rk1), k)
    noise = _jbinomial_multi(nk, big_n, p.tlwe_noise_scale, p.noise_bits)

    # b = sum_u a_u * K_u + e via Toeplitz matmul (K binary -> int8)
    t_key = poly.toeplitz_negacyclic(jnp.asarray(trlwe_k))  # (k, N, N)
    b = noise
    for u in range(k):
        b = b + _limb_matmul_i32(masks[u], t_key[u].astype(jnp.int8))

    bk = jnp.zeros((n * rows, k + 1, big_n), jnp.int32)
    for u in range(k):
        bk = bk.at[:, u, :].set(masks[u])
    bk = bk.at[:, k, :].set(b)
    bk = bk.reshape(n, rows, k + 1, big_n)
    # gadget message: row p = u*l + j gets s_i * h_j on component u
    h = host_kg.gadget_h(p)
    s_dev = jnp.asarray(lwe_s)
    for u in range(k + 1):
        for j in range(p.l):
            bk = bk.at[:, u * p.l + j, u, 0].add(
                s_dev * jnp.int32(h[j])
            )

    # ---- keyswitch key ----------------------------------------------------
    ks_root = prng.derive(master, 3)
    nrows = p.kN * p.ks_t
    r_keys = prng.derive_multi(ks_root, np.arange(nrows))
    rk = (jnp.asarray(r_keys[0].astype(np.uint32)),
          jnp.asarray(r_keys[1].astype(np.uint32)))
    a = _jbits_multi(_jderive(rk, 0), n).astype(jnp.int32)  # (nrows, n)
    e = _jbinomial_multi(
        _jderive(rk, 1), 1, p.lwe_noise_scale, p.noise_bits
    )[:, 0]
    hks = host_kg.ks_gadget_h(p).astype(np.int64)
    msg = (
        trlwe_k.reshape(-1).astype(np.int64)[:, None] * hks[None, :]
    ).reshape(-1).astype(np.int32)
    b_ks = (
        _limb_matmul_i32(a, s_dev[:, None].astype(jnp.int8))[:, 0]
        + jnp.asarray(msg) + e
    )
    ks = jnp.concatenate([a, b_ks[:, None]], axis=1)

    cloud = CloudKeySet(p, np.asarray(bk), np.asarray(ks))
    return SecretKeySet(
        p, LweKey(p, lwe_s), TrlweKey(p, trlwe_k), cloud
    )


def generate_gate_keypair_device(params: TFHEParams) -> GateKeyPair:
    return GateKeyPair(
        main=generate_secret_keyset_device(params, host_kg.MAIN_SEED),
        nbit=generate_secret_keyset_device(params, host_kg.NBIT_SEED),
    )
