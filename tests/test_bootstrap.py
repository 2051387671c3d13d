import numpy as np
import jax.numpy as jnp

from ieache import params as P
import ieache.boot.bootstrap as B
from ieache.boot import gates
from ieache.lwe import encrypt, keygen
from ieache.utils import prng


def _setup(p):
    ks = keygen.generate_secret_keyset(p)
    dck = B.pack_cloud_key(ks.cloud)
    return ks, dck


def _enc(ks, bits, salt=7):
    stream = prng.key_from_seed_words([salt])
    return jnp.asarray(encrypt.encrypt_bits(ks, np.asarray(bits), stream))


def test_bootstrap_refreshes_sign():
    p = P.TEST_TINY
    ks, dck = _setup(p)
    bits = np.array([0, 1, 1, 0, 1, 0, 0, 1])
    ct = _enc(ks, bits)
    out = B.bootstrap(ct, dck)
    assert out.shape == (8, p.n + 1)
    got = encrypt.decrypt_bits(ks, np.asarray(out))
    np.testing.assert_array_equal(got, bits)
    # phase must be re-centered near ±MU
    ph = encrypt.phase_of(ks, np.asarray(out)).astype(np.int64)
    assert np.all(np.abs(np.abs(ph) - (1 << 29)) < (1 << 25))


def test_all_two_input_gates_all_combos():
    p = P.TEST_TINY
    ks, dck = _setup(p)
    x = np.array([0, 0, 1, 1])
    y = np.array([0, 1, 0, 1])
    cx = _enc(ks, x, salt=1)
    cy = _enc(ks, y, salt=2)

    plain = {
        "AND": x & y,
        "OR": x | y,
        "NAND": 1 - (x & y),
        "NOR": 1 - (x | y),
        "XOR": x ^ y,
        "XNOR": 1 - (x ^ y),
        "ANDNY": (1 - x) & y,
        "ANDYN": x & (1 - y),
        "ORNY": (1 - x) | y,
        "ORYN": x | (1 - y),
    }
    for name, want in plain.items():
        fn = getattr(gates, name)
        got = encrypt.decrypt_bits(ks, np.asarray(fn(cx, cy, dck)))
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_not_copy_constant_mux():
    p = P.TEST_TINY
    ks, dck = _setup(p)
    x = np.array([0, 1, 1, 0])
    cx = _enc(ks, x, salt=3)
    np.testing.assert_array_equal(
        encrypt.decrypt_bits(ks, np.asarray(gates.NOT(cx))), 1 - x
    )
    np.testing.assert_array_equal(
        encrypt.decrypt_bits(ks, np.asarray(gates.COPY(cx))), x
    )
    np.testing.assert_array_equal(
        encrypt.decrypt_bits(
            ks, np.asarray(gates.CONSTANT(jnp.asarray(x), p.n))
        ),
        x,
    )
    sel = np.array([0, 0, 1, 1])
    a = np.array([1, 0, 1, 0])
    b = np.array([0, 1, 1, 0])
    out = gates.MUX(_enc(ks, sel, 4), _enc(ks, a, 5), _enc(ks, b, 6), dck)
    want = np.where(sel, a, b)
    np.testing.assert_array_equal(
        encrypt.decrypt_bits(ks, np.asarray(out)), want
    )


def test_mixed_gate_batch():
    p = P.TEST_TINY
    ks, dck = _setup(p)
    ops = jnp.asarray(
        [gates.GATE_OPCODES[g] for g in ["AND", "OR", "XOR", "NAND"]]
    )
    x = np.array([1, 0, 1, 1])
    y = np.array([1, 1, 1, 1])
    out = gates.apply_gate_batch(ops, _enc(ks, x, 8), _enc(ks, y, 9), dck)
    want = np.array([1 & 1, 0 | 1, 1 ^ 1, 1 - (1 & 1)])
    np.testing.assert_array_equal(
        encrypt.decrypt_bits(ks, np.asarray(out)), want
    )


def test_gate_chain_noiseless():
    """Chain gates through several bootstraps — noise must not accumulate."""
    p = P.TEST_TINY
    ks, dck = _setup(p)
    x = np.array([0, 1] * 4)
    c = _enc(ks, x, salt=11)
    for _ in range(4):
        c = gates.XOR(c, c, dck)       # always 0
        c = gates.NAND(c, c, dck)      # always 1
    got = encrypt.decrypt_bits(ks, np.asarray(c))
    np.testing.assert_array_equal(got, np.ones_like(x))


def test_bootstrap_noisy_params():
    p = P.TEST_SMALL_NOISY
    ks, dck = _setup(p)
    bits = prng.uniform_bits01(prng.key_from_seed_words([5]), 64)
    ct = _enc(ks, bits, salt=12)
    out = gates.AND(ct, ct, dck)  # AND(x,x) == x
    got = encrypt.decrypt_bits(ks, np.asarray(out))
    np.testing.assert_array_equal(got, bits)
