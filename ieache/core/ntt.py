"""Exact negacyclic NTT over small CRT primes — the small-batch
external-product path (SURVEY §7 hard part #1's proposed alternative).

The int8 Toeplitz path (core/poly.py, ops/pallas_kernels.py) pays a
batch-INDEPENDENT Toeplitz build + limb extraction every step.  This
module is the O(N log N)-per-lane exact alternative
(``IEACHE_STEP=ntt``):

* the torus operand is split into FOUR balanced 8-bit limbs (the
  same decomposition the Toeplitz path uses), so each limb convolution is
  bounded by |sum d * s_v| <= N*128*128 = 2^24 and the only TWO
  NTT-friendly primes below 2^15 (12289 and 18433 — k*2^11 + 1,
  providing the 2N = 2048-th roots the negacyclic twist needs at
  N = 1024; every other k*2048+1 < 2^15.3 is composite) give an exact
  CRT range of ~2^27.75 with a 2^2.75 margin;
* all modular arithmetic is Montgomery with R = 2^16: for p < 2^15
  every intermediate (T + m*p < 2^30 + 2^31) fits uint32 with
  wrapping — no floats, no int64, exact;
* the psi-twist is merged into the transform trees (the
  Longa–Naehrig / Kyber formulation): forward CT takes natural order
  to bit-reversed, the pointwise product is order-agnostic, and the
  inverse GS returns to natural order — no explicit bit-reversal
  permutation, and every butterfly stage is a contiguous
  (..., blocks, 2, span) reshape (XLA-friendly: no strided gathers);
* Montgomery bookkeeping: stage twiddles are stored in Montgomery
  form (exact muls, no drift); the single R^-1 defect from the
  pointwise product is cancelled by folding R^2 into the inverse's
  n^-1 scaling table.

Exactness is pinned against :func:`core.poly.negacyclic_mul_np`
(tests/test_ntt.py).
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

#: CRT primes: k * 2^11 + 1, < 2^15 (Montgomery-safe in uint32).
#: These are the ONLY two such primes; the byte-limb split keeps the
#: convolution range inside their product.
PRIMES = (12289, 18433)
R_BITS = 16
R = 1 << R_BITS
R_MASK = R - 1
#: 0x80808080 as a wrapped int32 (the byte-limb bias/XOR trick shared
#: with ops/pallas_kernels._LIMB_BIAS)
_LIMB_BIAS_NTT = -0x7F7F7F80


def _is_prime(p: int) -> bool:
    i = 2
    while i * i <= p:
        if p % i == 0:
            return False
        i += 1
    return p >= 2


def _find_generator(p: int) -> int:
    fac, m, d = [], p - 1, 2
    while d * d <= m:
        if m % d == 0:
            fac.append(d)
            while m % d == 0:
                m //= d
        d += 1
    if m > 1:
        fac.append(m)
    for g in range(2, p):
        if all(pow(g, (p - 1) // q, p) != 1 for q in fac):
            return g
    raise ValueError(f"no generator for {p}")


def _bitrev(i: int, bits: int) -> int:
    out = 0
    for _ in range(bits):
        out = (out << 1) | (i & 1)
        i >>= 1
    return out


@functools.lru_cache(maxsize=None)
def _host_tables(n: int):
    """Per-prime host tables (numpy) for length-n negacyclic NTT."""
    assert n & (n - 1) == 0
    logn = n.bit_length() - 1
    per = []
    for p in PRIMES:
        assert _is_prime(p) and (p - 1) % (2 * n) == 0 and p < (1 << 15)
        g = _find_generator(p)
        psi = pow(g, (p - 1) // (2 * n), p)      # primitive 2n-th root
        ipsi = pow(psi, p - 2, p)
        # bit-reversed psi power tables (Longa–Naehrig)
        psi_br = np.array(
            [pow(psi, _bitrev(i, logn), p) for i in range(n)],
            np.uint64,
        )
        ipsi_br = np.array(
            [pow(ipsi, _bitrev(i, logn), p) for i in range(n)],
            np.uint64,
        )
        ninv = pow(n, p - 2, p)
        pinv = (-pow(p, -1, R)) % R              # -p^-1 mod 2^16
        per.append({
            "p": p, "pinv": pinv,
            "psi_br_m": ((psi_br * R) % p).astype(np.uint32),
            "ipsi_br_m": ((ipsi_br * R) % p).astype(np.uint32),
            # n^-1 with the R^2 fold: mont_mul(x*R^-1, c) = x*n^-1
            # exactly when c = n^-1 * R^2 mod p
            "ninv_r2_m": np.uint32((ninv * R * R) % p),
            "ninv_r_m": np.uint32((ninv * R) % p),
        })
    p0, p1 = PRIMES
    crt = {
        "inv_p0_p1_m": np.uint32((pow(p0, -1, p1) * R) % p1),
        "p0_u32": np.uint32(p0 & 0xFFFFFFFF),
        "P_u32": np.uint32((p0 * p1) & 0xFFFFFFFF),
    }
    return {"logn": logn, "per": per, "crt": crt}


_DEV: dict = {}


def _dev_tables(n: int):
    if n not in _DEV:
        t = _host_tables(n)
        # concrete arrays even when first called under a jit trace
        with jax.ensure_compile_time_eval():
            for per in t["per"]:
                per["psi_br_j"] = jnp.asarray(per["psi_br_m"])
                per["ipsi_br_j"] = jnp.asarray(per["ipsi_br_m"])
        _DEV[n] = t
    return _DEV[n]


# -- Montgomery primitives (uint32, p < 2^15) -------------------------------

def _mont_mul(a, b, p: int, pinv: int):
    """a * b * R^-1 mod p (b is typically a Montgomery-form constant,
    making this exactly a*b' mod p)."""
    t = (a * b).astype(jnp.uint32)
    m = ((t & R_MASK) * jnp.uint32(pinv)) & R_MASK
    u = (t + m * jnp.uint32(p)) >> R_BITS
    return jnp.where(u >= p, u - jnp.uint32(p), u).astype(jnp.uint32)


def _add_mod(a, b, p: int):
    s = a + b
    return jnp.where(s >= p, s - jnp.uint32(p), s)


def _sub_mod(a, b, p: int):
    return jnp.where(a >= b, a - b, a + jnp.uint32(p) - b)


# -- transforms -------------------------------------------------------------

def _fwd_one(x, per, n: int, logn: int):
    """Negacyclic forward (psi merged): natural -> bit-reversed.

    x (..., n) uint32 in [0, p).  Every stage views the array as
    (..., m, 2, t) — m blocks of 2t contiguous elements — and uses one
    twiddle per block: psi_br[m + i]."""
    p, pinv = per["p"], per["pinv"]
    lead = x.shape[:-1]
    m, t = 1, n
    while m < n:
        t //= 2
        y = x.reshape(lead + (m, 2, t))
        u = y[..., 0, :]
        v = y[..., 1, :]
        s = jax.lax.slice_in_dim(per["psi_br_j"], m, 2 * m)
        s = s.reshape((1,) * len(lead) + (m, 1))
        vt = _mont_mul(v, s, p, pinv)
        x = jnp.stack([_add_mod(u, vt, p), _sub_mod(u, vt, p)],
                      axis=-2).reshape(lead + (n,))
        m *= 2
    return x


def _inv_one(x, per, n: int, logn: int, extra_r: bool):
    """Negacyclic inverse: bit-reversed -> natural, scaled by n^-1
    (and by R when ``extra_r`` — cancelling a pointwise R^-1 defect).
    """
    p, pinv = per["p"], per["pinv"]
    lead = x.shape[:-1]
    t, m = 1, n
    while m > 1:
        h = m // 2
        y = x.reshape(lead + (h, 2, t))
        u = y[..., 0, :]
        v = y[..., 1, :]
        s = jax.lax.slice_in_dim(per["ipsi_br_j"], h, 2 * h)
        s = s.reshape((1,) * len(lead) + (h, 1))
        x = jnp.stack(
            [_add_mod(u, v, p),
             _mont_mul(_sub_mod(u, v, p), s, p, pinv)],
            axis=-2,
        ).reshape(lead + (n,))
        t *= 2
        m = h
    c = per["ninv_r2_m"] if extra_r else per["ninv_r_m"]
    return _mont_mul(x, jnp.uint32(c), p, pinv)


def ntt_forward_digits(d: jnp.ndarray, n: int) -> jnp.ndarray:
    """Digit polys (..., N) int (|d| < p_min) -> spectra (P, ..., N)
    uint32 (bit-reversed order, normal domain)."""
    t = _dev_tables(n)
    outs = []
    for per in t["per"]:
        p = per["p"]
        x = d.astype(jnp.int32)
        x = jnp.where(x < 0, x + jnp.int32(p), x).astype(jnp.uint32)
        outs.append(_fwd_one(x, per, n, t["logn"]))
    return jnp.stack(outs)


def ntt_forward_torus_limbs(g: jnp.ndarray, n: int) -> jnp.ndarray:
    """Torus polys (..., N) int32 -> spectra (P, 4, ..., N) uint32 of
    the four balanced byte limbs (sum_v limb_v * 2^(8v) == g mod
    2^32, every limb in [-128, 127] — core.poly.split_i8_limbs).
    Precomputable for the bootstrapping key."""
    t = _dev_tables(n)
    x32 = (g.astype(jnp.int32)
           + jnp.int32(_LIMB_BIAS_NTT)) ^ jnp.int32(_LIMB_BIAS_NTT)
    outs = []
    for per in t["per"]:
        p = per["p"]
        limbs = []
        for v in range(4):
            limb = (x32 << (24 - 8 * v)) >> 24   # balanced byte_v
            xm = jnp.where(limb < 0, limb + jnp.int32(p), limb)
            limbs.append(
                _fwd_one(xm.astype(jnp.uint32), per, n, t["logn"])
            )
        outs.append(jnp.stack(limbs))
    return jnp.stack(outs)


def ntt_pointwise(a, b, prime_idx: int, n: int):
    """Spectrum product with an R^-1 defect (cancelled by the inverse
    when called with extra_r=True)."""
    per = _dev_tables(n)["per"][prime_idx]
    return _mont_mul(a, b, per["p"], per["pinv"])


def ntt_inverse(spec, prime_idx: int, n: int, extra_r: bool = True):
    per = _dev_tables(n)["per"][prime_idx]
    return _inv_one(spec, per, n, _dev_tables(n)["logn"], extra_r)


def crt_to_int32(v0, v1, n: int) -> jnp.ndarray:
    """Residues (uint32 in [0, p_i)) of a signed value |v| << P/2 ->
    v mod 2^32 as int32, exact (Garner mixed radix, two primes)."""
    t = _dev_tables(n)
    c = t["crt"]
    p0, p1 = PRIMES
    per1 = t["per"][1]
    d1 = _mont_mul(
        _sub_mod(v1, v0 % jnp.uint32(p1), p1),
        jnp.uint32(c["inv_p0_p1_m"]), p1, per1["pinv"],
    )
    x = (v0 + d1 * c["p0_u32"]).astype(jnp.uint32)
    # d1 >= p1/2 <=> negative integer (|v| <= 2^24 << P/2 ~ 2^26.75)
    neg = d1 >= jnp.uint32(p1 // 2)
    x = jnp.where(neg, x - c["P_u32"], x)
    return x.astype(jnp.int32)


def negacyclic_mul_ntt(d: jnp.ndarray, g: jnp.ndarray) -> jnp.ndarray:
    """Exact (mod 2^32) negacyclic product via the CRT-NTT path.

    d: (..., N) int digits (|d| <= 128); g: (..., N) int32 torus
    poly (broadcast-compatible with d).  Bit-identical to
    :func:`core.poly.negacyclic_mul_np`.
    """
    n = g.shape[-1]
    dh = ntt_forward_digits(d, n)                # (P, ..., N)
    gh = ntt_forward_torus_limbs(g, n)           # (P, 4, ..., N)
    out = None
    for v in range(4):
        res = [
            ntt_inverse(ntt_pointwise(dh[pi], gh[pi, v], pi, n),
                        pi, n)
            for pi in range(len(PRIMES))
        ]
        part = crt_to_int32(*res, n=n) << (8 * v)
        out = part if out is None else out + part
    return out.astype(jnp.int32)
