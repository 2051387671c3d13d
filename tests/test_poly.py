import numpy as np
import jax.numpy as jnp

from ieache.core import poly
from ieache.utils import prng


def _rand_torus(key, shape):
    return prng.uniform_torus32(key, int(np.prod(shape))).reshape(shape)


def _naive_negacyclic(a, b):
    """Schoolbook negacyclic product in Python ints, mod 2^32."""
    n = len(a)
    out = [0] * n
    for i in range(n):
        for j in range(n):
            k = i + j
            if k < n:
                out[k] += int(a[i]) * int(b[j])
            else:
                out[k - n] -= int(a[i]) * int(b[j])
    return np.array([((v + 2**31) % 2**32) - 2**31 for v in out], np.int32)


def test_negacyclic_mul_np_matches_schoolbook():
    key = prng.key_from_seed_words([1])
    n = 16
    a = _rand_torus(prng.derive(key, 0), (n,))
    b = _rand_torus(prng.derive(key, 1), (n,))
    np.testing.assert_array_equal(
        poly.negacyclic_mul_np(a, b), _naive_negacyclic(a, b)
    )


def test_split_i8_limbs_exact():
    key = prng.key_from_seed_words([2])
    x = _rand_torus(key, (256,))
    # include edge cases
    x = np.concatenate([x, np.array([0, 1, -1, 2**31 - 1, -(2**31), 127, -128,
                                     128, -129, 255, 256], np.int32)])
    limbs = np.asarray(poly.split_i8_limbs(jnp.asarray(x)))
    assert limbs.dtype == np.int8
    recon = np.zeros_like(x, np.int64)
    for v in range(poly.TORUS_LIMBS):
        recon += limbs[..., v].astype(np.int64) << (8 * v)
    np.testing.assert_array_equal(recon.astype(np.int32), x)


def test_toeplitz_negacyclic_structure():
    key = prng.key_from_seed_words([3])
    n = 32
    g = _rand_torus(key, (n,))
    t = np.asarray(poly.toeplitz_negacyclic(jnp.asarray(g)))
    e = np.concatenate([-g, g])
    for m in range(n):
        for j in range(n):
            assert t[m, j] == e[n + j - m]


def test_negacyclic_mul_small_matches_oracle():
    key = prng.key_from_seed_words([4])
    n = 64
    g = _rand_torus(prng.derive(key, 0), (n,))
    d = (prng.random_bits(prng.derive(key, 1), 5 * n).astype(np.int64)
         % 255 - 127).astype(np.int32).reshape(5, n)
    got = np.asarray(poly.negacyclic_mul_small(jnp.asarray(d), jnp.asarray(g)))
    want = poly.negacyclic_mul_np(d, g)
    np.testing.assert_array_equal(got, want)


def test_negacyclic_mul_batched_shapes():
    key = prng.key_from_seed_words([5])
    n = 16
    g = _rand_torus(prng.derive(key, 0), (n,))
    d = (prng.random_bits(prng.derive(key, 1), 2 * 3 * n).astype(np.int64)
         % 200 - 100).astype(np.int32).reshape(2, 3, n)
    out = poly.negacyclic_mul_small(jnp.asarray(d), jnp.asarray(g))
    assert out.shape == (2, 3, n)
    np.testing.assert_array_equal(
        np.asarray(out)[1, 2], poly.negacyclic_mul_np(d[1, 2], g)
    )
