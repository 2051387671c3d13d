"""Encrypted integer words: batched bit-arrays of LWE ciphertexts.

A *word* is ``int32 (B, W, n+1)``: B expressions in the batch, W bits
LSB-first (bit i of value v is ``(v >> i) & 1`` — the reference's
encryption order, ``/root/reference/Client1/alice.c:116-149``), each an
LWE ciphertext row.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ieache.boot import gates
from ieache.lwe import encrypt
from ieache.lwe.types import SecretKeySet


def values_to_bits(values, width: int) -> np.ndarray:
    """int array (B,) -> bit matrix (B, width), LSB-first (host)."""
    v = np.asarray(values, dtype=object)  # allow >64-bit python ints
    out = np.zeros((len(v), width), np.int32)
    for r, val in enumerate(v):
        val = int(val) & ((1 << width) - 1)
        for i in range(width):
            out[r, i] = (val >> i) & 1
    return out


def bits_to_values(bits) -> list:
    """bit matrix (B, W) LSB-first -> python ints (unsigned)."""
    bits = np.asarray(bits)
    return [
        sum(int(b) << i for i, b in enumerate(row)) for row in bits
    ]


def encrypt_word(ks: SecretKeySet, values, width: int, stream) -> jnp.ndarray:
    """Encrypt a batch of integers -> (B, width, n+1)."""
    bits = values_to_bits(values, width)
    return jnp.asarray(encrypt.encrypt_bits(ks, bits, stream))


def decrypt_word(ks: SecretKeySet, word) -> list:
    """(B, W, n+1) -> python ints (unsigned)."""
    return bits_to_values(encrypt.decrypt_bits(ks, word))


def decrypt_word_signed(ks: SecretKeySet, word) -> list:
    """Two's-complement interpretation over the word width."""
    bits = encrypt.decrypt_bits(ks, word)
    w = bits.shape[1]
    vals = bits_to_values(bits)
    return [v - (1 << w) if v >= (1 << (w - 1)) else v for v in vals]


def trivial_word(batch: int, width: int, n: int, value: int = 0) -> jnp.ndarray:
    """Trivial (noiseless) encrypted word of a public constant."""
    bits = values_to_bits([value] * batch, width)
    return gates.CONSTANT(jnp.asarray(bits), n)
