import numpy as np

from ieache.utils import prng


def test_threefry_known_vectors():
    # Random123 published test vectors for Threefry-2x32, 20 rounds.
    y0, y1 = prng.threefry2x32((0, 0), (0, 0))
    assert (int(y0), int(y1)) == (0x6B200159, 0x99BA4EFE)

    y0, y1 = prng.threefry2x32(
        (0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF)
    )
    assert (int(y0), int(y1)) == (0x1CB996FC, 0xBB002BE7)

    y0, y1 = prng.threefry2x32(
        (0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3)
    )
    assert (int(y0), int(y1)) == (0xC4923A9C, 0x483DF7A0)


def test_streams_deterministic_and_distinct():
    key = prng.key_from_seed_words([314, 1592, 657])
    a = prng.random_bits(key, 1000)
    b = prng.random_bits(key, 1000)
    np.testing.assert_array_equal(a, b)

    key2 = prng.key_from_seed_words([314, 1592, 888])
    c = prng.random_bits(key2, 1000)
    assert (a != c).mean() > 0.9

    d1 = prng.random_bits(prng.derive(key, 1), 1000)
    d2 = prng.random_bits(prng.derive(key, 2), 1000)
    assert (d1 != d2).mean() > 0.9
    assert (a != d1).mean() > 0.9


def test_jax_matches_numpy():
    key = prng.key_from_seed_words([1, 2, 3])
    host = prng.random_bits(key, 999)
    dev = np.asarray(prng.jax_random_bits(key, 999))
    np.testing.assert_array_equal(host, dev)


def test_binomial_noise_stats():
    key = prng.key_from_seed_words([42])
    x = prng.binomial_noise(key, 4096, scale=3, noise_bits=1024)
    # sigma = 3 * sqrt(1024)/2 = 48
    assert abs(x.mean()) < 5
    assert 40 < x.std() < 56
    assert prng.binomial_noise(key, 16, scale=0).tolist() == [0] * 16


def test_uniform_bits01():
    key = prng.key_from_seed_words([7])
    bits = prng.uniform_bits01(key, 10000)
    assert set(np.unique(bits)) <= {0, 1}
    assert 0.45 < bits.mean() < 0.55
