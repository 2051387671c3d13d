"""Deterministic keyset generation (host side).

Counterpart of the reference keygen binary
(``/root/reference/Keygen/keygen.c:15-59``): two keysets from fixed seed
words {314, 1592, 657} ("main") and {314, 1592, 888} ("nbit"),
exporting secret / cloud / nbit key material.  tfhe-lib's RNG is
replaced by the normative threefry stream spec of
:mod:`ieache.utils.prng`; the C++ oracle reproduces every array
below bit-for-bit (tests/test_oracle_parity.py).

Stream layout (normative):

    master          = key_from_seed_words(seed_words)
    lwe key bits    = uniform_bits01(derive(master, 0), n)
    trlwe key bits  = uniform_bits01(derive(master, 1), k*N)
    BK row (i, p)   : sub = derive(derive(derive(master, 2), i), p)
                      mask poly u < k : uniform_torus32(derive(sub, u), N)
                      noise           : binomial(derive(sub, k), N)
    KS row r=(i,j)  : sub = derive(derive(master, 3), r)
                      mask : uniform_torus32(derive(sub, 0), n)
                      noise: binomial(derive(sub, 1), 1)
"""

from __future__ import annotations

import numpy as np

from ieache.lwe.types import (
    CloudKeySet,
    GateKeyPair,
    LweKey,
    SecretKeySet,
    TrlweKey,
)
from ieache.params import TFHEParams
from ieache.utils import prng

#: the reference's fixed seeds, `Keygen/keygen.c:30-36`
MAIN_SEED = (314, 1592, 657)
NBIT_SEED = (314, 1592, 888)


def gadget_h(params: TFHEParams) -> np.ndarray:
    """TRGSW gadget constants h_j = 2^(32-(j+1)*bg_bit), int32 (l,)."""
    return np.array(
        [(1 << (32 - (j + 1) * params.bg_bit)) & 0xFFFFFFFF
         for j in range(params.l)],
        dtype=np.uint32,
    ).astype(np.int32)


def ks_gadget_h(params: TFHEParams) -> np.ndarray:
    """Keyswitch gadget constants 2^(32-(j+1)*ks_basebit), int32 (t,)."""
    return np.array(
        [(1 << (32 - (j + 1) * params.ks_basebit)) & 0xFFFFFFFF
         for j in range(params.ks_t)],
        dtype=np.uint32,
    ).astype(np.int32)


def _toeplitz_key(trlwe_key: TrlweKey) -> np.ndarray:
    """Negacyclic Toeplitz matrices of the TRLWE key polys: (k, N, N)."""
    p = trlwe_key.params
    k_coefs = trlwe_key.coefs
    n = p.N
    e = np.concatenate([-k_coefs, k_coefs], axis=-1)
    idx = n + np.arange(n)[None, :] - np.arange(n)[:, None]
    return e[:, idx]  # (k, N, N)


def generate_bootstrapping_key(
    master, lwe_key: LweKey, trlwe_key: TrlweKey
) -> np.ndarray:
    """TGSW encryptions of every LWE key bit: int32 (n, (k+1)l, k+1, N)."""
    p = lwe_key.params
    n, big_n, k, l = p.n, p.N, p.k, p.l
    rows = p.trgsw_rows
    t_key = _toeplitz_key(trlwe_key)  # (k, N, N) int32 in {-1,0,1}

    # stream keys for every (i, p) row
    bk_root = prng.derive(master, 2)
    i_keys = prng.derive_multi(bk_root, np.arange(n))
    # derive per-row: need derive(i_key, p) for each i — vectorize over i
    row_k0 = np.empty((n, rows), np.uint32)
    row_k1 = np.empty((n, rows), np.uint32)
    for pr in range(rows):
        y0, y1 = prng.threefry2x32(
            (i_keys[0], i_keys[1]),
            (np.full(n, pr, np.uint32), np.full(n, 0x9E3779B9, np.uint32)),
        )
        row_k0[:, pr] = y0
        row_k1[:, pr] = y1
    flat_keys = (row_k0.reshape(-1), row_k1.reshape(-1))  # (n*rows,)

    # masks: u < k uniform polys per row; noise stream at index k
    masks = np.empty((n * rows, k, big_n), np.int32)

    def _derive_all(keys, idx):
        y0, y1 = prng.threefry2x32(
            (keys[0], keys[1]),
            (np.full_like(keys[0], idx), np.full_like(keys[0], 0x9E3779B9)),
        )
        return (y0, y1)

    for u in range(k):
        mk = _derive_all(flat_keys, u)
        masks[:, u, :] = prng.random_bits_multi(mk, big_n).astype(np.int32)
    nk = _derive_all(flat_keys, k)
    noise = prng.binomial_noise_multi(
        nk, big_n, p.tlwe_noise_scale, p.noise_bits
    )  # (n*rows, N)

    # b = sum_u a_u * K_u + e  (exact mod 2^32 via int32 matmul)
    with np.errstate(over="ignore"):
        b = noise.copy()
        for u in range(k):
            b = b + masks[:, u, :] @ t_key[u]

    bk = np.zeros((n * rows, k + 1, big_n), np.int32)
    bk[:, :k, :] = masks
    bk[:, k, :] = b
    bk = bk.reshape(n, rows, k + 1, big_n)

    # add message * gadget: row p = u*l + j gets s_i * h_j on component u
    h = gadget_h(p)
    s = lwe_key.s.astype(np.int64)
    for u in range(k + 1):
        for j in range(l):
            with np.errstate(over="ignore"):
                bk[:, u * l + j, u, 0] = (
                    bk[:, u * l + j, u, 0] + (s * h[j]).astype(np.int32)
                )
    return bk


def generate_keyswitch_key(
    master, lwe_key: LweKey, trlwe_key: TrlweKey
) -> np.ndarray:
    """Linear keyswitch key: int32 (kN * t, n+1).

    Row i*t + j encrypts ``K_flat[i] * 2^(32-(j+1) ks_basebit)`` under
    the LWE key.
    """
    p = lwe_key.params
    n, t = p.n, p.ks_t
    kn = p.kN
    nrows = kn * t

    ks_root = prng.derive(master, 3)
    row_keys = prng.derive_multi(ks_root, np.arange(nrows))

    def _derive_all(keys, idx):
        y0, y1 = prng.threefry2x32(
            (keys[0], keys[1]),
            (np.full_like(keys[0], idx), np.full_like(keys[0], 0x9E3779B9)),
        )
        return (y0, y1)

    a = prng.random_bits_multi(
        _derive_all(row_keys, 0), n
    ).astype(np.int32)  # (nrows, n)
    e = prng.binomial_noise_multi(
        _derive_all(row_keys, 1), 1, p.lwe_noise_scale, p.noise_bits
    )[:, 0]  # (nrows,)

    h = ks_gadget_h(p).astype(np.int64)  # (t,)
    msg = (
        trlwe_key.extracted.astype(np.int64)[:, None] * h[None, :]
    ).reshape(-1)  # (nrows,)

    s = lwe_key.s
    with np.errstate(over="ignore"):
        b = (a @ s + msg.astype(np.int32) + e).astype(np.int32)
    out = np.empty((nrows, n + 1), np.int32)
    out[:, :n] = a
    out[:, n] = b
    return out


def generate_secret_keyset(
    params: TFHEParams, seed_words=MAIN_SEED
) -> SecretKeySet:
    """Full keyset (secret + cloud) from seed words — `keygen.c:30-51`."""
    master = prng.key_from_seed_words(seed_words)
    lwe_key = LweKey(
        params, prng.uniform_bits01(prng.derive(master, 0), params.n)
    )
    trlwe_key = TrlweKey(
        params,
        prng.uniform_bits01(
            prng.derive(master, 1), params.k * params.N
        ).reshape(params.k, params.N),
    )
    bk = generate_bootstrapping_key(master, lwe_key, trlwe_key)
    ks = generate_keyswitch_key(master, lwe_key, trlwe_key)
    cloud = CloudKeySet(params, bk, ks)
    return SecretKeySet(params, lwe_key, trlwe_key, cloud)


def generate_gate_keypair(params: TFHEParams,
                          nbit_params: TFHEParams | None = None
                          ) -> GateKeyPair:
    """The reference's two keysets (main + nbit), `keygen.c:30-36`."""
    return GateKeyPair(
        main=generate_secret_keyset(params, MAIN_SEED),
        nbit=generate_secret_keyset(nbit_params or params, NBIT_SEED),
    )


def cached_keyset(params: TFHEParams, seed_words, path: str
                  ) -> SecretKeySet:
    """Load the keyset at ``path``, or generate it and save it there.

    On an accelerator the keyset is generated on the device
    (``keygen_device``, bit-identical to the host generator)."""
    import os

    import jax

    from ieache.codec import files

    if os.path.exists(path):
        return files.load_secret_keyset(path)
    if jax.default_backend() == "cpu":
        ks = generate_secret_keyset(params, seed_words)
    else:
        from ieache.lwe.keygen_device import generate_secret_keyset_device

        ks = generate_secret_keyset_device(params, seed_words)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    files.save_secret_keyset(path, ks)
    return ks


def cached_gate_keypair(params: TFHEParams, cache_dir: str) -> GateKeyPair:
    """The main + nbit keysets of ``params``, cached in ``cache_dir``
    as ``<name>_.iek`` and ``<name>_nbit.iek``."""
    import os

    return GateKeyPair(
        main=cached_keyset(params, MAIN_SEED,
                           os.path.join(cache_dir, f"{params.name}_.iek")),
        nbit=cached_keyset(params, NBIT_SEED,
                           os.path.join(cache_dir,
                                        f"{params.name}_nbit.iek")),
    )
