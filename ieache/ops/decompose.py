"""Balanced gadget (digit) decomposition of torus32 values.

Used twice in the bootstrap pipeline:
* TRGSW external product: base 2^bg_bit, `l` levels (the digits feed the
  int8 matmuls of the blind-rotation step);
* LWE keyswitch: base 2^ks_basebit, `ks_t` levels.

The decomposition approximates the top ``levels * base_bit`` bits with
round-to-nearest and balanced digits in [-B/2, B/2):

    sum_j d_j * 2^(32 - (j+1) base_bit)  ==  x + err,
    |err| <= 2^(32 - levels*base_bit - 1)

Implementation is the classic offset trick (cf. tfhe-lib's
``tGswTorus32PolynomialDecompH``, interface consumed by the reference's
gates at /root/reference/Cloud/cloud.c:30-43): add
``offset = sum_j (B/2) 2^(32-(j+1)bb)`` in uint32, then each digit is a
shifted mask minus B/2.  Exact, branch-free, elementwise.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def _offset(base_bit: int, levels: int) -> int:
    off = 0
    for j in range(levels):
        off += (1 << (base_bit - 1)) << (32 - (j + 1) * base_bit)
    # round-to-nearest of the dropped low bits: without this half-ulp
    # term the residual has mean -2^(32-levels*bb-1), and inside one
    # blind-rotation step that bias couples coherently with the ~N/2
    # secret-key coefficients (error ~ s(X)*eps_a(X)), costing ~10x the
    # zero-mean residual noise at 16-bit coverage (measured 0.034 vs
    # 0.0035 torus stdev at l=2 — tools/margin_probe.py).
    if levels * base_bit < 32:
        off += 1 << (32 - levels * base_bit - 1)
    return off & 0xFFFFFFFF


def gadget_decompose(x: jnp.ndarray, base_bit: int, levels: int) -> jnp.ndarray:
    """int32 (...,) -> int32 (..., levels), balanced digits."""
    half = 1 << (base_bit - 1)
    mask = (1 << base_bit) - 1
    v = x.astype(jnp.uint32) + jnp.uint32(_offset(base_bit, levels))
    digits = []
    for j in range(levels):
        shift = 32 - (j + 1) * base_bit
        d = ((v >> shift) & mask).astype(jnp.int32) - half
        digits.append(d)
    return jnp.stack(digits, axis=-1)


def gadget_decompose_np(x: np.ndarray, base_bit: int, levels: int) -> np.ndarray:
    """NumPy twin (oracle/host path), bit-identical to the device version."""
    half = 1 << (base_bit - 1)
    mask = (1 << base_bit) - 1
    with np.errstate(over="ignore"):
        v = np.asarray(x).astype(np.uint32) + np.uint32(
            _offset(base_bit, levels)
        )
    digits = []
    for j in range(levels):
        shift = 32 - (j + 1) * base_bit
        d = ((v >> shift) & mask).astype(np.int32) - half
        digits.append(d)
    return np.stack(digits, axis=-1)
