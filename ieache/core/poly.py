"""Exact negacyclic torus-polynomial arithmetic on int8 matmuls.

TFHE works over T_N[X] = R[X]/(X^N + 1) with torus coefficients held as
int32 ("Torus32") and *exact* wraparound mod 2^32.  The reference
delegates this to tfhe-lib's spqlios double-precision FFT; this module
takes an exact integer route instead, built on int8 tensor-core
matmuls:

    negacyclic product  (small-digit poly) x (torus poly)
        == int8 matmul(s) against the negacyclic Toeplitz matrix of the
           torus poly, with the torus side split into four signed int8
           limbs.  Each s8 x s8 -> s32 matmul is exact; recombining the
           limb partial sums with wrapping int32 shifts is exact mod
           2^32.  No rounding error anywhere (unlike spqlios' FFT).

Key identities used throughout (d = digit poly, g = torus poly):

    (d * g)[j] = sum_m d[m] * e[N + j - m],   e = concat(-g, g)

so the matmul operand is ``T[m, j] = e[N + j - m]`` — built with
log2(N) static rolls (`_toeplitz`), which XLA lowers to cheap
slice+concat, not gathers.

Everything is batched over arbitrary leading axes and jit-safe.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

#: number of signed int8 limbs covering a torus32 coefficient
TORUS_LIMBS = 4


# ---------------------------------------------------------------------------
# NumPy oracle (exact, O(N^2)) — ground truth for unit tests and host keygen
# ---------------------------------------------------------------------------

def negacyclic_mul_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Exact negacyclic product of int32 polys, mod 2^32 (host/NumPy).

    Works on 1-D arrays or batches in the leading axes of `a` (with a
    single `b`).  Uses the Toeplitz form with int32 matmul, which in
    NumPy wraps mod 2^32 exactly like the device path.
    """
    a = np.asarray(a, np.int32)
    b = np.asarray(b, np.int32)
    n = b.shape[-1]
    e = np.concatenate([-b, b], axis=-1)  # wraps at INT32_MIN, as intended
    # T[m, j] = e[N + j - m]
    idx = (n + np.arange(n)[None, :] - np.arange(n)[:, None])
    t = e[..., idx]
    return (a.reshape(-1, n) @ t).reshape(a.shape).astype(np.int32)


# ---------------------------------------------------------------------------
# int8 limb decomposition
# ---------------------------------------------------------------------------

def split_i8_limbs(x: jnp.ndarray, nlimbs: int = TORUS_LIMBS) -> jnp.ndarray:
    """Split int32 -> `nlimbs` signed base-256 limbs (balanced, exact).

    Returns int8 with a new trailing axis of size `nlimbs`;
    ``sum_v limbs[..., v] * 2^(8 v) == x (mod 2^32)`` and every limb is
    in [-128, 127].
    """
    x = x.astype(jnp.int32)
    limbs = []
    for _ in range(nlimbs):
        s = ((x + 128) & 0xFF) - 128
        limbs.append(s.astype(jnp.int8))
        x = (x - s) >> 8
    return jnp.stack(limbs, axis=-1)


def split_i8_limbs_np(x: np.ndarray, nlimbs: int = TORUS_LIMBS) -> np.ndarray:
    x = np.asarray(x, np.int32)
    limbs = []
    for _ in range(nlimbs):
        s = (((x.astype(np.int64) + 128) & 0xFF) - 128).astype(np.int32)
        limbs.append(s.astype(np.int8))
        x = ((x - s) >> 8).astype(np.int32)
    return np.stack(limbs, axis=-1)


# ---------------------------------------------------------------------------
# Negacyclic Toeplitz construction (static rolls only)
# ---------------------------------------------------------------------------

def negacyclic_extend(g: jnp.ndarray) -> jnp.ndarray:
    """concat(-g, g) along the last axis: e[s] s.t. T[m,j] = e[N+j-m]."""
    return jnp.concatenate([-g, g], axis=-1)


def _toeplitz_from_extended(e: jnp.ndarray, n: int) -> jnp.ndarray:
    """(..., 2N) -> (..., N, 2N) where row m = roll(e, m).

    Built by log2(N) doublings of static rolls; row m of the result is
    the circular right-shift of `e` by m.  The negacyclic matmul
    operand is then ``rows[..., N:]``.
    """
    assert e.shape[-1] == 2 * n
    rows = e[..., None, :]
    size = 1
    while size < n:
        rows = jnp.concatenate(
            [rows, jnp.roll(rows, size, axis=-1)], axis=-2
        )
        size *= 2
    return rows


def _toeplitz_rows(e: jnp.ndarray, nrows: int) -> jnp.ndarray:
    """(..., L) -> (..., nrows, L) where row m = roll(e, m), any L.

    Generalization of :func:`_toeplitz_from_extended` to windows whose
    length is not 2N — used by the SP-sharded bootstrap to build only
    a local Toeplitz column block from a short sliding window.
    """
    rows = e[..., None, :]
    size = 1
    while size < nrows:
        step = min(size, nrows - size)
        rows = jnp.concatenate(
            [rows, jnp.roll(rows[..., :step, :], size, axis=-1)],
            axis=-2,
        )
        size += step
    return rows


def toeplitz_negacyclic(g: jnp.ndarray) -> jnp.ndarray:
    """(..., N) int -> (..., N, N) T with (d * g)[j] = sum_m d[m] T[m, j]."""
    n = g.shape[-1]
    e = negacyclic_extend(g)
    return _toeplitz_from_extended(e, n)[..., n:]


# ---------------------------------------------------------------------------
# Exact digit x torus negacyclic product as int8 matmuls
# ---------------------------------------------------------------------------

def _dot_i8(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """int8 x int8 -> int32 matmul (batched on a's leading axes)."""
    return jax.lax.dot_general(
        a,
        b,
        dimension_numbers=(((a.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )


def negacyclic_mul_small(d: jnp.ndarray, g: jnp.ndarray) -> jnp.ndarray:
    """Exact (mod 2^32) negacyclic product, |d| <= 127, g torus32.

    d: (..., N) int — digit polynomial(s), must fit int8.
    g: (N,) int32 — torus polynomial (single; batch via vmap if needed).
    Returns (..., N) int32.
    """
    n = g.shape[-1]
    t = toeplitz_negacyclic(g)                 # (N, N) int32
    t_limbs = split_i8_limbs(t)                # (N, N, 4) int8
    d8 = d.astype(jnp.int8)
    out = jnp.zeros(d.shape[:-1] + (n,), jnp.int32)
    for v in range(TORUS_LIMBS):
        part = _dot_i8(d8, t_limbs[..., v])    # (..., N) int32, exact
        out = out + (part << (8 * v))          # wrapping shift: mod 2^32
    return out
