"""Deterministic counter-based PRNG (Threefry-2x32-20).

The reference's keygen is reproducible from fixed seed words
``{314, 1592, 657}`` / ``{314, 1592, 888}`` via tfhe-lib's global RNG
(``/root/reference/Keygen/keygen.c:30-36``).  We cannot reproduce
tfhe-lib's stream without the library, so this module *defines* the
framework's RNG: a self-contained Threefry-2x32 implementation whose
spec is mirrored bit-for-bit by the C++ oracle in
``ieache/native/src/threefry.cc``.  Everything key- or
noise-related derives from it, which is what makes "bit-exact keygen /
encrypt / gate-eval / decrypt across JAX and the native oracle"
testable (see ``tests/test_oracle_parity.py``).

Stream spec (normative):

* a *key* is a pair of uint32 ``(k0, k1)``;
* ``key_from_seed_words([w0, w1, ...])`` folds arbitrary seed words:
  starting from ``(0, 0)``, for each word ``w`` at index ``i`` the key
  becomes ``threefry2x32(key, (w, i))``;
* ``derive(key, i)`` = ``threefry2x32(key, (i, 0x9E3779B9))`` gives
  independent sub-streams;
* ``random_bits(key, n)`` returns ``n`` uint32 words: block ``j``
  yields words ``2j`` and ``2j+1`` as ``threefry2x32(key, (j, 0))``
  ... i.e. counter pair ``(x0, x1) = (j, 0)``.

Both a NumPy implementation (host-side keygen) and a jax.numpy
implementation (on-device sampling) are provided and agree bit-exactly.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS_A = (13, 15, 26, 6)
_ROTATIONS_B = (17, 29, 16, 24)
_PARITY = np.uint32(0x1BD11BDA)
_GOLDEN = 0x9E3779B9


def _rotl(x, r, xp):
    r = np.uint32(r)
    return (x << r) | (x >> np.uint32(32 - r))


def _threefry2x32_core(k0, k1, x0, x1, xp):
    """One Threefry-2x32-20 block. All args uint32 arrays (broadcastable)."""
    ks0, ks1 = k0, k1
    ks2 = k0 ^ k1 ^ _PARITY

    x0 = x0 + ks0
    x1 = x1 + ks1

    def four_rounds(x0, x1, rots):
        for r in rots:
            x0 = x0 + x1
            x1 = _rotl(x1, r, xp)
            x1 = x1 ^ x0
        return x0, x1

    x0, x1 = four_rounds(x0, x1, _ROTATIONS_A)
    x0, x1 = x0 + ks1, x1 + ks2 + np.uint32(1)
    x0, x1 = four_rounds(x0, x1, _ROTATIONS_B)
    x0, x1 = x0 + ks2, x1 + ks0 + np.uint32(2)
    x0, x1 = four_rounds(x0, x1, _ROTATIONS_A)
    x0, x1 = x0 + ks0, x1 + ks1 + np.uint32(3)
    x0, x1 = four_rounds(x0, x1, _ROTATIONS_B)
    x0, x1 = x0 + ks1, x1 + ks2 + np.uint32(4)
    x0, x1 = four_rounds(x0, x1, _ROTATIONS_A)
    x0, x1 = x0 + ks2, x1 + ks0 + np.uint32(5)
    return x0, x1


# ---------------------------------------------------------------------------
# NumPy (host) implementation
# ---------------------------------------------------------------------------

def threefry2x32(key, x):
    """key=(k0,k1), x=(x0,x1) of uint32 scalars/arrays -> (y0,y1)."""
    k0 = np.asarray(key[0], np.uint32)
    k1 = np.asarray(key[1], np.uint32)
    x0 = np.asarray(x[0], np.uint32)
    x1 = np.asarray(x[1], np.uint32)
    with np.errstate(over="ignore"):
        return _threefry2x32_core(k0, k1, x0, x1, np)


def key_from_seed_words(words) -> tuple:
    """Fold arbitrary uint32 seed words into a (k0, k1) key."""
    k0 = np.uint32(0)
    k1 = np.uint32(0)
    for i, w in enumerate(words):
        k0, k1 = threefry2x32((k0, k1), (np.uint32(w), np.uint32(i)))
    return (np.uint32(k0), np.uint32(k1))


def derive(key, i) -> tuple:
    """Derive an independent sub-stream key."""
    y0, y1 = threefry2x32(key, (np.uint32(i), np.uint32(_GOLDEN)))
    return (np.uint32(y0), np.uint32(y1))


def deterministic_mode() -> bool:
    """IEACHE_DETERMINISTIC=1 pins protocol-path encryption streams to
    their labels (repro/testing only — see fresh_stream)."""
    import os

    return os.environ.get("IEACHE_DETERMINISTIC", "0") == "1"


def fresh_stream(*label_words) -> tuple:
    """Entropy-backed stream key for protocol-path encryptions.

    The reference draws fresh randomness for every ``bootsSymEncrypt``
    (`Client1/alice.c:116-149`).  Deriving the stream purely from
    deployment-stable labels (client index, serve count, opcode) makes
    two deployments encrypting different values at the same label emit
    ciphertexts with IDENTICAL a-vectors and noise, so ``c - c' =
    (0, Δm + Δe)`` leaks the plaintext-bit difference outright.
    Default: fold 128 bits of ``os.urandom`` after the label words.
    ``IEACHE_DETERMINISTIC=1`` restores pure label derivation for
    reproduction and the oracle-parity tests.
    """
    words = [np.uint32(int(w) & 0xFFFFFFFF) for w in label_words]
    if not deterministic_mode():
        import os

        words += list(np.frombuffer(os.urandom(16), np.uint32))
    return key_from_seed_words(words)


def random_bits(key, n: int) -> np.ndarray:
    """n uint32 words from the stream of `key` (host/NumPy)."""
    nblocks = (n + 1) // 2
    ctr = np.arange(nblocks, dtype=np.uint32)
    zero = np.zeros(nblocks, dtype=np.uint32)
    y0, y1 = threefry2x32(key, (ctr, zero))
    out = np.empty(2 * nblocks, dtype=np.uint32)
    out[0::2] = y0
    out[1::2] = y1
    return out[:n]


def uniform_torus32(key, n: int) -> np.ndarray:
    """n uniform torus elements as int32."""
    return random_bits(key, n).astype(np.int32)


def uniform_bits01(key, n: int) -> np.ndarray:
    """n uniform bits in {0,1} as int32 (lowest bit of each word)."""
    return (random_bits(key, n) & np.uint32(1)).astype(np.int32)


def binomial_noise(key, n: int, scale: int, noise_bits: int = 1024) -> np.ndarray:
    """n centered-binomial noise samples, in torus32 units (int32).

    Each sample is ``scale * (popcount(noise_bits random bits) -
    noise_bits/2)``; stddev = ``scale * sqrt(noise_bits) / 2``.
    A zero ``scale`` short-circuits to zeros (noiseless test params).
    """
    if scale == 0:
        return np.zeros(n, dtype=np.int32)
    words_per = noise_bits // 32
    w = random_bits(key, n * words_per).reshape(n, words_per)
    pop = _popcount32(w).sum(axis=1).astype(np.int64)
    centered = pop - noise_bits // 2
    return (centered * scale).astype(np.int32)


def _popcount32(v: np.ndarray) -> np.ndarray:
    """SWAR popcount of uint32 arrays (no memory blow-up)."""
    v = v.astype(np.uint32)
    v = v - ((v >> 1) & np.uint32(0x55555555))
    v = (v & np.uint32(0x33333333)) + ((v >> 2) & np.uint32(0x33333333))
    v = (v + (v >> 4)) & np.uint32(0x0F0F0F0F)
    with np.errstate(over="ignore"):
        return ((v * np.uint32(0x01010101)) >> 24).astype(np.int32)


# -- vectorized multi-stream variants (same per-stream outputs) -------------

def derive_multi(key, indices) -> tuple:
    """Vectorized `derive`: indices (R,) -> (k0s, k1s) arrays of shape (R,)."""
    idx = np.asarray(indices, np.uint32)
    y0, y1 = threefry2x32(key, (idx, np.full_like(idx, _GOLDEN)))
    return (y0, y1)


def random_bits_multi(keys, n: int) -> np.ndarray:
    """Per-stream bits: keys = (k0s, k1s) of shape (R,) -> uint32 (R, n)."""
    k0, k1 = (np.asarray(k, np.uint32) for k in keys)
    nblocks = (n + 1) // 2
    ctr = np.arange(nblocks, dtype=np.uint32)[None, :]
    with np.errstate(over="ignore"):
        y0, y1 = _threefry2x32_core(
            k0[:, None], k1[:, None], ctr, np.zeros_like(ctr), np
        )
    out = np.empty((k0.shape[0], 2 * nblocks), dtype=np.uint32)
    out[:, 0::2] = y0
    out[:, 1::2] = y1
    return out[:, :n]


def binomial_noise_multi(keys, n: int, scale: int,
                         noise_bits: int = 1024) -> np.ndarray:
    """Per-stream centered binomial noise: (R, n) int32."""
    k0 = np.asarray(keys[0], np.uint32)
    r = k0.shape[0]
    if scale == 0:
        return np.zeros((r, n), dtype=np.int32)
    words_per = noise_bits // 32
    w = random_bits_multi(keys, n * words_per).reshape(r, n, words_per)
    pop = _popcount32(w).sum(axis=2).astype(np.int64)
    return ((pop - noise_bits // 2) * scale).astype(np.int32)


# ---------------------------------------------------------------------------
# jax.numpy (device) implementation — same spec, same outputs
# ---------------------------------------------------------------------------

def jax_threefry2x32(key, x0, x1):
    import jax.numpy as jnp

    k0 = jnp.asarray(key[0], jnp.uint32)
    k1 = jnp.asarray(key[1], jnp.uint32)
    return _threefry2x32_core(
        k0, k1, jnp.asarray(x0, jnp.uint32), jnp.asarray(x1, jnp.uint32), jnp
    )


def jax_random_bits(key, n: int):
    import jax.numpy as jnp

    nblocks = (n + 1) // 2
    ctr = jnp.arange(nblocks, dtype=jnp.uint32)
    zero = jnp.zeros(nblocks, dtype=jnp.uint32)
    y0, y1 = jax_threefry2x32(key, ctr, zero)
    out = jnp.stack([y0, y1], axis=1).reshape(-1)
    return out[:n]
