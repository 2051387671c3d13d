import numpy as np
import jax.numpy as jnp

import ieache.boot.bootstrap as B
from ieache import params as P
from ieache.boot import gates
from ieache.circuits import arith, words
from ieache.lwe import keygen
from ieache.utils import prng

_KS = None
_DCK = None


def _setup():
    global _KS, _DCK
    if _KS is None:
        _KS = keygen.generate_secret_keyset(P.TEST_TINY)
        _DCK = B.pack_cloud_key(_KS.cloud)
    return _KS, _DCK


def _enc(ks, vals, width, salt):
    return words.encrypt_word(
        ks, vals, width, prng.key_from_seed_words([salt])
    )


def test_ripple_add_16bit():
    """BASELINE config 2: the 16-bit homomorphic ripple-carry adder."""
    ks, dck = _setup()
    rng = np.random.RandomState(0)
    a = rng.randint(0, 1 << 16, size=6)
    b = rng.randint(0, 1 << 16, size=6)
    ca = _enc(ks, a, 16, 1)
    cb = _enc(ks, b, 16, 2)
    zero_c = gates.CONSTANT(jnp.zeros((6,), jnp.int32), ks.params.n)
    s, cout = arith.ripple_add(ca, cb, zero_c, dck)
    got = words.decrypt_word(ks, s)
    want = [(int(x) + int(y)) & 0xFFFF for x, y in zip(a, b)]
    assert got == want
    carry_got = np.asarray(
        jnp.asarray(cout)[None] if cout.ndim == 1 else cout
    )
    from ieache.lwe import encrypt
    carry_bits = encrypt.decrypt_bits(ks, np.asarray(cout))
    want_carry = [(int(x) + int(y)) >> 16 for x, y in zip(a, b)]
    assert carry_bits.tolist() == want_carry


def test_ripple_sub_signed():
    ks, dck = _setup()
    a = [5, 100, 7, 250]
    b = [3, 200, 7, 1]
    ca = _enc(ks, a, 8, 3)
    cb = _enc(ks, b, 8, 4)
    s, _ = arith.ripple_sub(ca, cb, dck)
    got = words.decrypt_word(ks, s)
    assert got == [(x - y) & 0xFF for x, y in zip(a, b)]
    # signed (two's complement) view where the result fits 8 bits
    got_signed = words.decrypt_word_signed(ks, s)
    assert got_signed[:3] == [2, -100, 0]


def test_twos_complement():
    ks, dck = _setup()
    vals = [0, 1, 77, 255]
    c = _enc(ks, vals, 8, 5)
    neg = arith.twos_complement(c, dck)
    got = words.decrypt_word(ks, neg)
    want = [(-v) & 0xFF for v in vals]
    assert got == want


def test_kogge_stone_matches_ripple():
    ks, dck = _setup()
    rng = np.random.RandomState(1)
    a = rng.randint(0, 1 << 12, size=4)
    b = rng.randint(0, 1 << 12, size=4)
    ca = _enc(ks, a, 12, 6)
    cb = _enc(ks, b, 12, 7)
    s, cout = arith.kogge_stone_add(ca, cb, dck)
    got = words.decrypt_word(ks, s)
    want = [(int(x) + int(y)) & 0xFFF for x, y in zip(a, b)]
    assert got == want

    one = gates.CONSTANT(jnp.ones((4,), jnp.int32), ks.params.n)
    s2, _ = arith.kogge_stone_add(ca, cb, dck, carry_in=one)
    got2 = words.decrypt_word(ks, s2)
    assert got2 == [(int(x) + int(y) + 1) & 0xFFF for x, y in zip(a, b)]


def test_schoolbook_mul():
    ks, dck = _setup()
    rng = np.random.RandomState(2)
    a = rng.randint(0, 1 << 6, size=4)
    b = rng.randint(0, 1 << 6, size=4)
    ca = _enc(ks, a, 6, 8)
    cb = _enc(ks, b, 6, 9)
    prod = arith.schoolbook_mul(ca, cb, dck)
    got = words.decrypt_word(ks, prod)
    want = [int(x) * int(y) for x, y in zip(a, b)]
    assert got == want


def test_zero_and_not_word():
    ks, dck = _setup()
    z = arith.zero_word(3, 8, ks.params.n)
    assert words.decrypt_word(ks, z) == [0, 0, 0]
    vals = [0b1010, 0xFF, 0]
    c = _enc(ks, vals, 8, 10)
    got = words.decrypt_word(ks, arith.not_word(c))
    assert got == [(~v) & 0xFF for v in vals]
