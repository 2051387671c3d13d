"""Symmetric LWE encryption/decryption of gate-bootstrapping bits.

Counterpart of ``bootsSymEncrypt`` / ``bootsSymDecrypt`` as used by the
reference encryptor/decryptor (``/root/reference/Client1/alice.c:116-149``,
``/root/reference/Output/verif.c:91-95``): a bit is the torus message
+1/8 (true) or -1/8 (false); decryption is the sign of the phase.

Host (NumPy) implementation; batched over a leading axis.  Device-side
batch encryption lives with the gate API (ieache/boot).
"""

from __future__ import annotations

import numpy as np

from ieache.lwe.types import SecretKeySet
from ieache.utils import prng

#: torus encoding of a gate-bootstrapping bit: 1/8 of the torus
MU = np.int32(1 << 29)


def encrypt_bits(keyset: SecretKeySet, bits, stream_key) -> np.ndarray:
    """Encrypt a bit array -> LWE batch int32 (..., n+1).

    `stream_key` is a prng key; sample r of the flattened batch uses
    sub-stream derive(stream_key, r) with mask at derive(sub, 0) and
    noise at derive(sub, 1)  (normative; mirrored by the C++ oracle).

    Large batches route to the device implementation when JAX's
    default backend is an accelerator (the host NumPy threefry is the
    slow part of a large operand word — IEACHE_DEVICE_ENCRYPT=0/1
    overrides the auto choice; both paths are bit-identical,
    tests/test_lwe.py).  The routed result is a
    *device* array (np.asarray it for a host copy); the host path
    returns np.ndarray.
    """
    p = keyset.params
    bits = np.asarray(bits)
    flat = bits.reshape(-1).astype(np.int64)
    r = flat.shape[0]

    import os

    mode = os.environ.get("IEACHE_DEVICE_ENCRYPT", "auto")
    if mode != "0" and (
        mode == "1"
        or (r >= 4096 and _default_backend_is_accelerator())
    ):
        return encrypt_bits_device(keyset, bits, stream_key)

    row_keys = prng.derive_multi(stream_key, np.arange(r))

    def _derive_all(keys, idx):
        y0, y1 = prng.threefry2x32(
            (keys[0], keys[1]),
            (np.full_like(keys[0], idx), np.full_like(keys[0], 0x9E3779B9)),
        )
        return (y0, y1)

    a = prng.random_bits_multi(_derive_all(row_keys, 0), p.n).astype(np.int32)
    e = prng.binomial_noise_multi(
        _derive_all(row_keys, 1), 1, p.lwe_noise_scale, p.noise_bits
    )[:, 0]
    mu = np.where(flat != 0, MU, -MU).astype(np.int32)
    s = keyset.lwe_key.s
    with np.errstate(over="ignore"):
        b = (a @ s + mu + e).astype(np.int32)
    out = np.concatenate([a, b[:, None]], axis=1)
    return out.reshape(bits.shape + (p.n + 1,))


def _default_backend_is_accelerator() -> bool:
    try:
        import jax

        return jax.default_backend() != "cpu"
    except Exception:  # pragma: no cover
        return False


_DEVICE_ENCRYPT_FNS: dict = {}


def _device_encrypt_fn(params):
    """One jitted program per parameter set: a single device dispatch
    per encrypt call."""
    fn = _DEVICE_ENCRYPT_FNS.get(params)
    if fn is None:
        import jax
        import jax.numpy as jnp
        from ieache.lwe.keygen_device import (
            _jbinomial_multi, _jbits_multi, _jderive, _limb_matmul_i32,
        )

        n = params.n
        scale = params.lwe_noise_scale
        noise_bits = params.noise_bits

        @jax.jit
        def fn(k0, k1, flat, s8):
            keys = (k0, k1)
            a = _jbits_multi(_jderive(keys, 0), n).astype(jnp.int32)
            e = _jbinomial_multi(
                _jderive(keys, 1), 1, scale, noise_bits
            )[:, 0]
            mu = jnp.where(flat != 0, MU, jnp.int32(-MU))
            b = _limb_matmul_i32(a, s8)[:, 0] + mu + e
            return jnp.concatenate([a, b[:, None]], axis=1)

        _DEVICE_ENCRYPT_FNS[params] = fn
    return _DEVICE_ENCRYPT_FNS[params]


def encrypt_bits_device(keyset: SecretKeySet, bits, stream_key) -> np.ndarray:
    """Device (jnp) twin of :func:`encrypt_bits` — same normative
    threefry stream layout, bit-identical output; the threefry mask
    generation and the exact a·s contraction run on the accelerator
    (int8-limb matmuls, as in keygen_device) in one jitted dispatch."""
    p = keyset.params
    bits = np.asarray(bits)
    flat = bits.reshape(-1)
    r = flat.shape[0]

    rk = prng.derive_multi(stream_key, np.arange(r))
    out = _device_encrypt_fn(p)(
        rk[0].astype(np.uint32), rk[1].astype(np.uint32),
        flat.astype(np.int32), keyset.lwe_key.s.astype(np.int8)[:, None],
    )
    # stays a device array: the consumer is the on-device evaluator,
    # and a (B, 256, n+1) operand word is ~0.5 GB that would otherwise
    # cross the host link twice.  np.asarray(result) materializes when
    # a host copy is needed.
    return out.reshape(bits.shape + (p.n + 1,))


def decrypt_bits(keyset: SecretKeySet, lwe) -> np.ndarray:
    """Decrypt LWE batch (..., n+1) -> bit array (...,) of int32 {0,1}.

    Device-resident ciphertexts decrypt on device (only the bit array
    crosses the host boundary — a (B, 256)-word ciphertext is ~0.5 GB,
    its bits 1 MB)."""
    if _is_device_array(lwe) and lwe.size >= 4096 * 501:
        return decrypt_bits_device(keyset, lwe)
    p = keyset.params
    lwe = np.asarray(lwe, np.int32)
    a = lwe[..., : p.n]
    b = lwe[..., p.n]
    s = keyset.lwe_key.s
    with np.errstate(over="ignore"):
        phase = (b - a @ s).astype(np.int32)
    return (phase > 0).astype(np.int32)


def _is_device_array(x) -> bool:
    try:
        import jax

        return isinstance(x, jax.Array) and _default_backend_is_accelerator()
    except Exception:  # pragma: no cover
        return False


_DEVICE_DECRYPT_FNS: dict = {}


def decrypt_bits_device(keyset: SecretKeySet, lwe) -> np.ndarray:
    """Device twin of :func:`decrypt_bits` (bit-identical)."""
    p = keyset.params
    fn = _DEVICE_DECRYPT_FNS.get(p)
    if fn is None:
        import jax
        import jax.numpy as jnp
        from ieache.lwe.keygen_device import _limb_matmul_i32

        n = p.n

        @jax.jit
        def fn(flat, s8):
            a, b = flat[:, :n], flat[:, n]
            phase = b - _limb_matmul_i32(a, s8)[:, 0]
            return (phase > 0).astype(jnp.int32)

        _DEVICE_DECRYPT_FNS[p] = fn
    import jax.numpy as jnp

    flat = jnp.reshape(lwe, (-1, p.n + 1))
    out = fn(flat, keyset.lwe_key.s.astype(np.int8)[:, None])
    return np.asarray(out).reshape(lwe.shape[:-1])


def phase_of(keyset: SecretKeySet, lwe) -> np.ndarray:
    """Raw phase (b - a.s) as int32 — for noise-margin diagnostics."""
    p = keyset.params
    lwe = np.asarray(lwe, np.int32)
    with np.errstate(over="ignore"):
        return (lwe[..., p.n] - lwe[..., : p.n] @ keyset.lwe_key.s).astype(
            np.int32
        )


def trivial(bits, params) -> np.ndarray:
    """Noiseless 'trivial' LWE samples (a=0, b=±MU) for constants."""
    bits = np.asarray(bits)
    out = np.zeros(bits.shape + (params.n + 1,), np.int32)
    out[..., params.n] = np.where(bits != 0, MU, -MU)
    return out
