import numpy as np

from ieache import params as P
from ieache.lwe import encrypt, keygen
from ieache.utils import prng


def test_keygen_shapes_and_determinism():
    p = P.TEST_TINY
    ks1 = keygen.generate_secret_keyset(p)
    ks2 = keygen.generate_secret_keyset(p)
    assert ks1.lwe_key.s.shape == (p.n,)
    assert set(np.unique(ks1.lwe_key.s)) <= {0, 1}
    assert ks1.trlwe_key.coefs.shape == (p.k, p.N)
    assert ks1.cloud.bk.shape == (p.n, p.trgsw_rows, p.k + 1, p.N)
    assert ks1.cloud.ks.shape == (p.kN * p.ks_t, p.n + 1)
    np.testing.assert_array_equal(ks1.cloud.bk, ks2.cloud.bk)
    np.testing.assert_array_equal(ks1.cloud.ks, ks2.cloud.ks)

    other = keygen.generate_secret_keyset(p, keygen.NBIT_SEED)
    assert not np.array_equal(other.lwe_key.s, ks1.lwe_key.s)


def test_encrypt_decrypt_roundtrip():
    p = P.TEST_TINY
    ks = keygen.generate_secret_keyset(p)
    stream = prng.key_from_seed_words([99])
    bits = prng.uniform_bits01(prng.derive(stream, 0), 64).reshape(4, 16)
    ct = encrypt.encrypt_bits(ks, bits, prng.derive(stream, 1))
    assert ct.shape == (4, 16, p.n + 1)
    np.testing.assert_array_equal(encrypt.decrypt_bits(ks, ct), bits)


def test_encrypt_device_bit_identical_to_host():
    """encrypt_bits_device == host encrypt_bits array-for-array (both
    follow the normative threefry stream layout), at noisy params and
    across the auto-routing threshold."""
    p = P.TEST_SMALL_NOISY
    ks = keygen.generate_secret_keyset(p)
    stream = prng.key_from_seed_words([0xD1])
    bits = prng.uniform_bits01(prng.derive(stream, 0), 8192).reshape(
        64, 128
    )
    host = encrypt.encrypt_bits(ks, bits, prng.derive(stream, 1))
    dev = encrypt.encrypt_bits_device(ks, bits, prng.derive(stream, 1))
    np.testing.assert_array_equal(dev, host)
    np.testing.assert_array_equal(encrypt.decrypt_bits(ks, dev), bits)


def test_encrypt_decrypt_roundtrip_noisy():
    p = P.TEST_SMALL_NOISY
    ks = keygen.generate_secret_keyset(p)
    stream = prng.key_from_seed_words([100])
    bits = prng.uniform_bits01(prng.derive(stream, 0), 256)
    ct = encrypt.encrypt_bits(ks, bits, prng.derive(stream, 1))
    np.testing.assert_array_equal(encrypt.decrypt_bits(ks, ct), bits)
    # phases should concentrate near ±MU
    ph = encrypt.phase_of(ks, ct).astype(np.int64)
    assert np.all(np.abs(np.abs(ph) - (1 << 29)) < (1 << 26))


def test_bk_rows_encrypt_gadget_messages():
    """Noiseless TGSW rows must have phase == ±s_i * h_j * K (exact)."""
    from ieache.core import poly

    p = P.TEST_TINY
    ks = keygen.generate_secret_keyset(p)
    bk = ks.cloud.bk
    kpoly = ks.trlwe_key.coefs
    h = keygen.gadget_h(p)
    s = ks.lwe_key.s
    for i in (0, p.n - 1):
        for u in range(p.k + 1):
            for j in range(p.l):
                row = bk[i, u * p.l + j]  # (k+1, N)
                with np.errstate(over="ignore"):
                    phase = row[p.k].copy()
                    for uu in range(p.k):
                        phase = phase - poly.negacyclic_mul_np(
                            row[uu], kpoly[uu]
                        )
                # message is s_i * h_j on component u:
                # phase = b - a.K = e + msg_b - msg_a * K
                expect = np.zeros(p.N, np.int32)
                if u == p.k:
                    expect[0] = np.int32(s[i] * np.int64(h[j]))
                else:
                    with np.errstate(over="ignore"):
                        expect = (
                            -np.int32(s[i]) * np.int32(h[j]) * kpoly[u]
                        ).astype(np.int32)
                np.testing.assert_array_equal(phase, expect)


def test_ks_rows_encrypt_extracted_key():
    p = P.TEST_TINY
    ks = keygen.generate_secret_keyset(p)
    s = ks.lwe_key.s
    kflat = ks.trlwe_key.extracted
    h = keygen.ks_gadget_h(p)
    tbl = ks.cloud.ks
    with np.errstate(over="ignore"):
        phase = (tbl[:, p.n] - tbl[:, : p.n] @ s).astype(np.int32)
    msg = (
        kflat.astype(np.int64)[:, None] * h.astype(np.int64)[None, :]
    ).reshape(-1).astype(np.int32)
    np.testing.assert_array_equal(phase, msg)
