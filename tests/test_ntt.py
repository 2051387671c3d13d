"""Exactness pins for the CRT-NTT negacyclic path (core/ntt.py)."""

import numpy as np
import jax.numpy as jnp

from ieache.core import ntt, poly


def test_primes_support_2048th_roots():
    for p in ntt.PRIMES:
        assert ntt._is_prime(p)
        assert (p - 1) % 2048 == 0
        assert p < (1 << 15)          # Montgomery-safe in uint32
    P = 1
    for p in ntt.PRIMES:
        P *= p
    # limb-product range: N * 128 * 2^15 = 2^32 signed
    assert P > (1 << 25)  # byte-limb range 2^24


def test_forward_inverse_roundtrip():
    n = 64
    rng = np.random.RandomState(0)
    x = rng.randint(-128, 128, (3, n)).astype(np.int32)
    f = ntt.ntt_forward_digits(jnp.asarray(x), n)
    for pi, per in enumerate(ntt._dev_tables(n)["per"]):
        p = per["p"]
        back = np.asarray(ntt.ntt_inverse(f[pi], pi, n, extra_r=False))
        want = np.mod(x, p).astype(np.uint32)
        np.testing.assert_array_equal(back, want)


def test_negacyclic_mul_matches_numpy_oracle():
    for n in (64, 256, 1024):
        rng = np.random.RandomState(n)
        d = rng.randint(-128, 128, (4, n)).astype(np.int32)
        g = rng.randint(-2**31, 2**31, (n,)).astype(np.int32)
        got = np.asarray(
            ntt.negacyclic_mul_ntt(jnp.asarray(d), jnp.asarray(g))
        )
        want = poly.negacyclic_mul_np(d, g)
        np.testing.assert_array_equal(got, want, err_msg=f"n={n}")


def test_negacyclic_mul_edge_values():
    n = 128
    cases = [
        (np.full((1, n), 127, np.int32),
         np.full((n,), -2**31, np.int32)),
        (np.full((1, n), -128, np.int32),
         np.full((n,), 2**31 - 1, np.int32)),
        (np.zeros((1, n), np.int32), np.ones((n,), np.int32)),
    ]
    one = np.zeros((1, n), np.int32)
    one[0, 0] = 1
    cases.append((one, np.arange(n, dtype=np.int32) - n // 2))
    for d, g in cases:
        got = np.asarray(
            ntt.negacyclic_mul_ntt(jnp.asarray(d), jnp.asarray(g))
        )
        np.testing.assert_array_equal(got, poly.negacyclic_mul_np(d, g))


def test_blind_rotate_ntt_mode_bit_exact():
    """IEACHE_STEP=ntt runs the whole blind rotation through
    the CRT-NTT external product, bit-identical to the default path."""
    import os

    import jax

    from ieache import params as P
    from ieache.ops import blind_rotate as br

    p = P.TEST_TINY
    rng = np.random.RandomState(5)
    b = 4
    acc0 = rng.randint(-2**31, 2**31, (b, p.k + 1, p.N)).astype(np.int32)
    bara = rng.randint(0, 2 * p.N, (b, p.n)).astype(np.int32)
    bk = rng.randint(-2**31, 2**31,
                     (p.n, p.trgsw_rows, p.k + 1, p.N)).astype(np.int32)

    want = np.asarray(br.blind_rotate(
        jnp.asarray(acc0), jnp.asarray(bara), jnp.asarray(bk), p))

    os.environ["IEACHE_STEP"] = "ntt"
    jax.clear_caches()
    try:
        got = np.asarray(br.blind_rotate(
            jnp.asarray(acc0), jnp.asarray(bara), jnp.asarray(bk), p))
    finally:
        del os.environ["IEACHE_STEP"]
        jax.clear_caches()
    np.testing.assert_array_equal(got, want)
