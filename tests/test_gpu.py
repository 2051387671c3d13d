"""Checks that need an NVIDIA GPU: the Hopper kernel compiled for the
card against the plain step, and the λ=110 bootstrap against the C++
oracle.  They skip elsewhere; on a GPU machine:

    IEACHE_TEST_GPU=1 python -m pytest tests/ -m gpu
"""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

from ieache import params as P

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("b", [1, 8, 1024, 1056])
@pytest.mark.parametrize("p", [P.IEACHE_110, P.IEACHE_110_FAST],
                         ids=lambda p: p.name)
def test_kernel_matches_plain_on_card(gpu, p, b):
    from ieache.ops import blind_rotate as br

    rng = np.random.default_rng(b)
    acc = jnp.asarray(rng.integers(-2**31, 2**31, (b, p.k + 1, p.N))
                      .astype(np.int32))
    bara = jnp.asarray(rng.integers(0, 2 * p.N, (b,)).astype(np.int32))
    bk_i = jnp.asarray(rng.integers(
        -2**31, 2**31, (p.trgsw_rows, p.k + 1, p.N)).astype(np.int32))
    want = br.external_product_step(acc, bara, bk_i, p, "plain")
    got = br.external_product_step(acc, bara, bk_i, p, "kernel")
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("p", [
    dataclasses.replace(P.IEACHE_110, n=32, name="fullgeo_l3"),
    dataclasses.replace(P.IEACHE_110_FAST, n=32, name="fullgeo_l2"),
], ids=lambda p: p.name)
def test_bootstrap_matches_oracle_on_card(gpu, p):
    import ieache.boot.bootstrap as boot
    from ieache.lwe import encrypt, keygen
    from ieache.native import lib as native
    from ieache.utils import prng

    ks = keygen.generate_secret_keyset(p)
    dck = boot.pack_cloud_key(ks.cloud)
    stream = prng.key_from_seed_words([91, p.l])
    bits = prng.uniform_bits01(prng.derive(stream, 0), 8)
    ct = encrypt.encrypt_bits(ks, bits, prng.derive(stream, 1))
    got = np.asarray(boot.bootstrap(jnp.asarray(ct), dck))
    want = native.oracle_bootstrap(p, ks.cloud.bk, ks.cloud.ks, ct)
    np.testing.assert_array_equal(got, want)
