"""Statistical noise-margin checks (the correctness budget of params.py).

The gate-bootstrapping failure condition is |phase noise| > 1/16 of
the torus at the bootstrap input.  These tests measure the actual
phase error distribution after bootstraps at the noisy test parameters
and assert a comfortable sigma margin, plus a long gate-chain survival
test (noise must not accumulate across bootstraps).
"""

import numpy as np
import jax.numpy as jnp

import ieache.boot.bootstrap as B
from ieache import params as P
from ieache.boot import gates
from ieache.lwe import encrypt, keygen
from ieache.utils import prng

MU = 1 << 29


def test_bootstrap_output_noise_margin():
    p = P.TEST_SMALL_NOISY
    ks = keygen.generate_secret_keyset(p)
    dck = B.pack_cloud_key(ks.cloud)
    bits = prng.uniform_bits01(prng.key_from_seed_words([1]), 256)
    ct = jnp.asarray(
        encrypt.encrypt_bits(ks, bits, prng.key_from_seed_words([2]))
    )
    out = np.asarray(gates.AND(ct, ct, dck))  # AND(x,x) = x
    ph = encrypt.phase_of(ks, out).astype(np.float64)
    err = np.where(bits == 1, ph - MU, ph + MU)
    sigma = err.std()
    # the margin to a wrong gate decision at the NEXT bootstrap input
    # is 1/16 of the torus for the worst-case linear combo (XOR: 2x)
    margin = 2**32 / 16
    assert sigma > 0  # noise params really are noisy
    assert margin / (2 * sigma + 1e-9) > 6, (
        f"sigma={sigma:.3e}, margin ratio too small"
    )


def test_long_gate_chain_survives():
    p = P.TEST_SMALL_NOISY
    ks = keygen.generate_secret_keyset(p)
    dck = B.pack_cloud_key(ks.cloud)
    bits = prng.uniform_bits01(prng.key_from_seed_words([3]), 64)
    c = jnp.asarray(
        encrypt.encrypt_bits(ks, bits, prng.key_from_seed_words([4]))
    )
    ref = bits.copy()
    for i in range(10):
        c = gates.XOR(c, c, dck)     # -> 0
        c = gates.NAND(c, c, dck)    # -> 1
        c = gates.ANDYN(c, c, dck)   # 1 and not 1 -> 0
        c = gates.ORNY(c, c, dck)    # not 0 or 0 -> 1
    got = encrypt.decrypt_bits(ks, np.asarray(c))
    np.testing.assert_array_equal(got, np.ones_like(ref))
