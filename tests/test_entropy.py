"""Protocol-path encryption randomness must be entropy-backed.

The reference draws fresh RNG for every ``bootsSymEncrypt``
(`/root/reference/Client1/alice.c:116-149`).  A deterministic stream
derived only from deployment-stable labels (client index, serve count)
would give two deployments encrypting different values IDENTICAL
a-vectors and noise, so ``c - c'`` leaks the plaintext-bit difference.
These tests pin the default-entropy / opt-in-determinism contract of
``prng.fresh_stream``.
"""

import numpy as np

from ieache import params as P
from ieache.lwe import keygen
from ieache.mp import nodes
from ieache.utils import prng

_CACHE = {}


def _keypair():
    if "pair" not in _CACHE:
        _CACHE["pair"] = keygen.generate_gate_keypair(P.TEST_TINY)
    return _CACHE["pair"]


def _client_with_keys(index=1):
    c = nodes.ClientNode(index)
    pair = _keypair()
    c.main_ks = pair.main
    c.nbit_ks = pair.nbit
    c.set_value([5], width=8)
    return c


def test_fresh_stream_unique_per_call(monkeypatch):
    monkeypatch.delenv("IEACHE_DETERMINISTIC", raising=False)
    k1 = prng.fresh_stream(1, 2, 3)
    k2 = prng.fresh_stream(1, 2, 3)
    assert (int(k1[0]), int(k1[1])) != (int(k2[0]), int(k2[1]))


def test_fresh_stream_deterministic_flag(monkeypatch):
    monkeypatch.setenv("IEACHE_DETERMINISTIC", "1")
    k1 = prng.fresh_stream(1, 2, 3)
    k2 = prng.fresh_stream(1, 2, 3)
    assert (int(k1[0]), int(k1[1])) == (int(k2[0]), int(k2[1]))
    # and it is exactly the label derivation (repro contract)
    k3 = prng.key_from_seed_words([1, 2, 3])
    assert (int(k1[0]), int(k1[1])) == (int(k3[0]), int(k3[1]))


def test_node_encrypt_operand_fresh_avectors(monkeypatch):
    """Two deployments at the same (index, serve_count) label must NOT
    repeat ciphertext a-vectors (VERDICT r2 weak #2)."""
    monkeypatch.delenv("IEACHE_DETERMINISTIC", raising=False)
    op1 = _client_with_keys().encrypt_operand()
    op2 = _client_with_keys().encrypt_operand()
    assert not np.array_equal(np.asarray(op1.value)[..., :-1],
                              np.asarray(op2.value)[..., :-1])
    # both still decrypt to the same plaintext bits
    from ieache.lwe import encrypt
    pair = _keypair()
    b1 = np.asarray(encrypt.decrypt_bits(pair.main, np.asarray(op1.value)))
    b2 = np.asarray(encrypt.decrypt_bits(pair.main, np.asarray(op2.value)))
    assert np.array_equal(b1, b2)


def test_node_encrypt_operand_deterministic_flag(monkeypatch):
    monkeypatch.setenv("IEACHE_DETERMINISTIC", "1")
    op1 = _client_with_keys().encrypt_operand()
    op2 = _client_with_keys().encrypt_operand()
    assert np.array_equal(np.asarray(op1.value), np.asarray(op2.value))
