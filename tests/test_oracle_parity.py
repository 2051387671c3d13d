"""Bit-exactness gate: JAX core vs the native C++ oracle.

The BASELINE requires "bit-exact keygen/encrypt/gate-eval/decrypt vs
reference TFHE test vectors"; the oracle (ieache/native) is the
framework's normative reference implementation (plain C++ modular
arithmetic + schoolbook polynomial products).  Every array compared
here must match exactly — any mismatch means either the int8 matmul
path or the oracle broke the spec.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import ieache.boot.bootstrap as B
from ieache import params as P
from ieache.lwe import encrypt, keygen
from ieache.native import lib as native
from ieache.utils import prng


@pytest.fixture(scope="module")
def oracle():
    try:
        native.get_lib()
    except Exception as e:  # pragma: no cover
        pytest.skip(f"native build failed: {e}")
    return native


def test_threefry_parity(oracle):
    out = np.zeros(2, np.uint32)
    oracle.get_lib().tf_threefry(0, 0, 0, 0, out)
    assert tuple(out) == (0x6B200159, 0x99BA4EFE)
    got = np.zeros(1001, np.uint32)
    key = prng.key_from_seed_words([314, 1592, 657])
    oracle.get_lib().tf_random_bits(int(key[0]), int(key[1]), got, 1001)
    np.testing.assert_array_equal(got, prng.random_bits(key, 1001))


@pytest.mark.parametrize("pname", ["TEST_TINY", "TEST_SMALL_NOISY"])
def test_keygen_parity(oracle, pname):
    p = getattr(P, pname)
    ks = keygen.generate_secret_keyset(p)
    s, k, bk, kst = oracle.oracle_keygen(p, keygen.MAIN_SEED)
    np.testing.assert_array_equal(s, ks.lwe_key.s)
    np.testing.assert_array_equal(k, ks.trlwe_key.coefs)
    np.testing.assert_array_equal(bk, ks.cloud.bk)
    np.testing.assert_array_equal(kst, ks.cloud.ks)


def test_encrypt_decrypt_parity(oracle):
    p = P.TEST_SMALL_NOISY
    ks = keygen.generate_secret_keyset(p)
    stream = prng.key_from_seed_words([77])
    bits = prng.uniform_bits01(prng.derive(stream, 5), 64)
    host = encrypt.encrypt_bits(ks, bits, prng.derive(stream, 6))
    nat = oracle.oracle_encrypt(
        p, ks.lwe_key.s, bits, prng.derive(stream, 6)
    )
    np.testing.assert_array_equal(nat, host)
    np.testing.assert_array_equal(
        oracle.oracle_decrypt(p, ks.lwe_key.s, nat), bits
    )


def test_bootstrap_parity(oracle):
    """THE gate: full gate bootstrap, JAX path vs C++ oracle."""
    p = P.TEST_TINY
    ks = keygen.generate_secret_keyset(p)
    dck = B.pack_cloud_key(ks.cloud)
    stream = prng.key_from_seed_words([88])
    bits = np.array([0, 1, 1, 0, 1, 0])
    ct = encrypt.encrypt_bits(ks, bits, stream)

    jax_out = np.asarray(B.bootstrap(jnp.asarray(ct), dck))
    nat_out = oracle.oracle_bootstrap(p, ks.cloud.bk, ks.cloud.ks, ct)
    np.testing.assert_array_equal(jax_out, nat_out)


def test_bootstrap_parity_noisy(oracle):
    p = P.TEST_SMALL_NOISY
    ks = keygen.generate_secret_keyset(p)
    dck = B.pack_cloud_key(ks.cloud)
    stream = prng.key_from_seed_words([89])
    bits = prng.uniform_bits01(prng.derive(stream, 0), 4)
    ct = encrypt.encrypt_bits(ks, bits, prng.derive(stream, 1))

    jax_out = np.asarray(B.bootstrap(jnp.asarray(ct), dck))
    nat_out = oracle.oracle_bootstrap(p, ks.cloud.bk, ks.cloud.ks, ct)
    np.testing.assert_array_equal(jax_out, nat_out)
    np.testing.assert_array_equal(
        oracle.oracle_decrypt(p, ks.lwe_key.s, nat_out), bits
    )


#: full production geometry (N=1024, full noise scales) with a small
#: LWE dimension so the O(n * N^2) schoolbook oracle stays test-sized;
#: one per gadget: (8,2) = the default fast single-limb path, (10,2) =
#: the tfhe-lib-compatible TWO-limb digit path (never oracle-compared
#: in round 1 — VERDICT #6)
import dataclasses  # noqa: E402

FULLGEO_L2 = dataclasses.replace(
    P.IEACHE_110_FAST, n=32, name="fullgeo_l2"
)
FULLGEO_COMPAT = dataclasses.replace(
    P.IEACHE_110_TFHE_COMPAT, n=32, name="fullgeo_compat"
)


@pytest.mark.parametrize("p", [FULLGEO_L2, FULLGEO_COMPAT],
                         ids=lambda p: p.name)
def test_bootstrap_parity_full_geometry(oracle, p):
    """N=1024 with production noise scales and both gadget geometries
    — pins the full-size rotate/decompose/keyswitch code paths
    (incl. the two-limb (Bgbit=10, l=2) digit split) to the oracle."""
    ks = keygen.generate_secret_keyset(p)
    s, k, bk, kst = oracle.oracle_keygen(p, keygen.MAIN_SEED)
    np.testing.assert_array_equal(s, ks.lwe_key.s)
    np.testing.assert_array_equal(k, ks.trlwe_key.coefs)
    np.testing.assert_array_equal(bk, ks.cloud.bk)
    np.testing.assert_array_equal(kst, ks.cloud.ks)

    dck = B.pack_cloud_key(ks.cloud)
    stream = prng.key_from_seed_words([90, p.bg_bit, p.l])
    bits = prng.uniform_bits01(prng.derive(stream, 0), 4)
    ct = encrypt.encrypt_bits(ks, bits, prng.derive(stream, 1))

    jax_out = np.asarray(B.bootstrap(jnp.asarray(ct), dck))
    nat_out = oracle.oracle_bootstrap(p, ks.cloud.bk, ks.cloud.ks, ct)
    np.testing.assert_array_equal(jax_out, nat_out)
