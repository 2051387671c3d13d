import numpy as np
import jax.numpy as jnp

import ieache.boot.bootstrap as B
from ieache import params as P
from ieache.boot import gates
from ieache.circuits import fused, words
from ieache.lwe import keygen
from ieache.utils import prng

_C = {}


def _setup():
    if "ks" not in _C:
        _C["ks"] = keygen.generate_secret_keyset(P.TEST_TINY)
        _C["dck"] = B.pack_cloud_key(_C["ks"].cloud)
    return _C["ks"], _C["dck"]


def _enc(ks, vals, width, salt):
    return words.encrypt_word(
        ks, vals, width, prng.key_from_seed_words([salt])
    )


def test_fused_ripple_add():
    ks, dck = _setup()
    rng = np.random.RandomState(0)
    a = rng.randint(0, 1 << 12, 5)
    b = rng.randint(0, 1 << 12, 5)
    ca = _enc(ks, a, 12, 1)
    cb = _enc(ks, b, 12, 2)
    zero = gates.CONSTANT(jnp.zeros((5,), jnp.int32), ks.params.n)
    s, cout = fused.ripple_add(ca, cb, zero, dck)
    assert words.decrypt_word(ks, s) == [
        (int(x) + int(y)) & 0xFFF for x, y in zip(a, b)
    ]


def test_adder_modes_exhaustive():
    """maj2 and ref5 adder circuits: all 8 (x, y, carry) combinations
    per bit, multi-bit carry propagation, identical results."""
    ks, dck = _setup()
    n = ks.params.n
    # all 4 (x, y) pairs at every bit + long carry chains
    a = [0b1111, 0b1010, 0b0110, 0b0001]
    b = [0b0001, 0b0101, 0b0110, 0b1111]
    ca = _enc(ks, a, 4, 21)
    cb = _enc(ks, b, 4, 22)
    for cin in (0, 1):
        cc = gates.CONSTANT(jnp.full((4,), cin, jnp.int32), n)
        want = [(x + y + cin) & 0xF for x, y in zip(a, b)]
        for mode in ("maj2", "ref5"):
            s, cout = fused.ripple_add(ca, cb, cc, dck, mode=mode)
            assert words.decrypt_word(ks, s) == want, mode
            # carry-out of 0b1111 + 0b0001 (+cin) must be 1
            from ieache.lwe import encrypt

            co = encrypt.decrypt_bits(ks, np.asarray(cout))
            want_co = [(x + y + cin) >> 4 for x, y in zip(a, b)]
            np.testing.assert_array_equal(co, want_co), mode


def test_fused_twos_complement_and_chain():
    ks, dck = _setup()
    vals = [0, 3, 200, 255]
    c = _enc(ks, vals, 8, 3)
    neg = fused.twos_complement(c, dck)
    assert words.decrypt_word(ks, neg) == [(-v) & 0xFF for v in vals]

    a = _enc(ks, [30, 1], 8, 4)
    b = _enc(ks, [12, 2], 8, 5)
    cc = _enc(ks, [50, 3], 8, 6)
    s = fused.add_then_sub(a, b, cc, dck)
    got = words.decrypt_word_signed(ks, s)
    assert got == [30 + 12 - 50, 1 + 2 - 3]


def test_fused_mul():
    ks, dck = _setup()
    rng = np.random.RandomState(1)
    a = rng.randint(0, 1 << 5, 4)
    b = rng.randint(0, 1 << 5, 4)
    ca = _enc(ks, a, 5, 7)
    cb = _enc(ks, b, 5, 8)
    prod = fused.schoolbook_mul_fused(ca, cb, dck)
    assert words.decrypt_word(ks, prod) == [
        int(x) * int(y) for x, y in zip(a, b)
    ]


def test_wallace_latency_multiplier_matches_csa():
    """The latency multiplier (one-wave partials + Wallace-tree 3:2
    compression + prefix final add, r5) is value-identical to the
    windowed CSA across widths, including asymmetric ones."""
    ks, dck = _setup()
    fz = fused
    s = prng.key_from_seed_words([0xBA])
    rng = np.random.RandomState(9)
    for wx, wy in ((8, 8), (8, 3), (5, 8), (8, 1)):
        av = rng.randint(0, 1 << wx, 4)
        bv = rng.randint(0, 1 << wy, 4)
        xw = words.encrypt_word(ks, av, wx, prng.derive(s, wx * 16 + wy))
        yw = words.encrypt_word(ks, bv, wy,
                                prng.derive(s, wx * 16 + wy + 1))
        fast = words.decrypt_word(
            ks, np.asarray(fz.schoolbook_mul_csa(xw, yw, dck,
                                                 latency=True)))
        slow = words.decrypt_word(
            ks, np.asarray(fz.schoolbook_mul_csa(xw, yw, dck)))
        want = [(int(a) * int(b)) % (1 << (wx + wy))
                for a, b in zip(av, bv)]
        assert fast == slow == want, (wx, wy)
