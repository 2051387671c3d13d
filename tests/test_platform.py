"""Platform plumbing: native AES key wrapping, device routing of
encrypt/decrypt, the compile-cache helper, the keyset cache, and the
entry points that must refuse to run without a GPU."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import jax

from ieache.lwe import encrypt, keygen
from ieache.mp import keywrap
from ieache.native.lib import aes256_cbc
from ieache.utils import cache, prng

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# NIST SP 800-38A, F.2.5 / F.2.6 (CBC-AES256)
NIST_KEY = bytes.fromhex(
    "603deb1015ca71be2b73aef0857d77811f352c073b6108d72d9810a30914dff4")
NIST_IV = bytes.fromhex("000102030405060708090a0b0c0d0e0f")
NIST_PLAIN = bytes.fromhex(
    "6bc1bee22e409f96e93d7e117393172a" "ae2d8a571e03ac9c9eb76fac45af8e51"
    "30c81c46a35ce411e5fbc1191a0a52ef" "f69f2445df4f9b17ad2b417be66c3710")
NIST_CIPHER = bytes.fromhex(
    "f58c4c04d6e5f1ba779eabfb5f7bfbd6" "9cfc4e967edb808d679f777bc6702c7d"
    "39f23369a9d9bacfa530e26304231461" "b2eb05e2c39be9fcda6c19078c6a9d1b")

#: a ".hacklab" blob written by the earlier pycryptodome/cryptography
#: implementation of the reference framing (16-char size header, IV,
#: space-padded CBC) — the native cipher must read and write it as is
FRAMING_KEY = bytes(range(32))
FRAMING_IV = bytes(range(100, 116))
FRAMING_DATA = b"IE-ACHE .hacklab framing check " * 3 + b"tail"
FRAMING_BLOB = bytes.fromhex(
    "30303030303030303030303030303937"
    "6465666768696a6b6c6d6e6f70717273"
    "ab346ee8b52093c1c361d0aeee68c9df5de7f3b06121b0535c31b2b9e6815c50"
    "92ee6af2419e9d4e6ddaa9ea6298e4dc66078cd0b978cdc9a4b16b5c78662508"
    "8554eee09de92fbb7bbb30ad66d4339fe3ed54fbb00abc71f0feaddb5cc643a1"
    "6e644a163ab15178609c82216ea5c13e")


@pytest.mark.parametrize("decrypt", [False, True])
def test_native_aes_nist_vectors(decrypt):
    src, dst = ((NIST_CIPHER, NIST_PLAIN) if decrypt
                else (NIST_PLAIN, NIST_CIPHER))
    assert aes256_cbc(NIST_KEY, NIST_IV, src, decrypt=decrypt) == dst


def test_native_aes_refuses_partial_blocks_and_short_keys():
    with pytest.raises(ValueError, match="multiple of 16"):
        aes256_cbc(NIST_KEY, NIST_IV, b"x" * 17)
    with pytest.raises(ValueError, match="32-byte key"):
        aes256_cbc(NIST_KEY[:16], NIST_IV, b"x" * 16)


def test_keywrap_matches_reference_framing():
    assert keywrap.encrypt_bytes(FRAMING_KEY, FRAMING_DATA,
                                 iv=FRAMING_IV) == FRAMING_BLOB
    assert keywrap.decrypt_bytes(FRAMING_KEY, FRAMING_BLOB) == FRAMING_DATA


def test_keywrap_imports_without_cryptography():
    code = ("import sys; sys.modules['cryptography'] = None; "
            "from ieache.mp import keywrap; "
            "k = bytes(32); b = keywrap.encrypt_bytes(k, b'abc'); "
            "assert keywrap.decrypt_bytes(k, b) == b'abc'")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("backend,device", [("cpu", False), ("gpu", True)])
def test_large_encrypt_routes_to_device_off_cpu(monkeypatch, backend,
                                                device):
    from ieache import params as P

    ks = keygen.generate_secret_keyset(P.TEST_TINY)
    calls = []
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    monkeypatch.delenv("IEACHE_DEVICE_ENCRYPT", raising=False)
    monkeypatch.setattr(encrypt, "encrypt_bits_device",
                        lambda *a: calls.append(a) or "device")
    bits = np.zeros(4096, np.int32)
    out = encrypt.encrypt_bits(ks, bits, prng.key_from_seed_words([1]))
    assert (out == "device") if device else (out.shape == (4096, 9))
    assert len(calls) == int(device)


@pytest.mark.parametrize("backend,device", [("cpu", False), ("gpu", True)])
def test_large_decrypt_routes_to_device_off_cpu(monkeypatch, backend,
                                                device):
    from ieache import params as P

    ks = keygen.generate_secret_keyset(P.TEST_TINY)
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    monkeypatch.setattr(encrypt, "decrypt_bits_device",
                        lambda *a: "device")
    lwe = jax.numpy.zeros((4096 * 501 // (P.TEST_TINY.n + 1) + 1,
                           P.TEST_TINY.n + 1), jax.numpy.int32)
    out = encrypt.decrypt_bits(ks, lwe)
    assert (isinstance(out, str) and out == "device") if device \
        else out.shape == (lwe.shape[0],)


def test_compile_cache_defaults_to_checkout(monkeypatch):
    seen = {}
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: seen.__setitem__(k, v))
    path = cache.enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert seen == {"jax_compilation_cache_dir": path}


def test_compile_cache_leaves_env_to_jax(monkeypatch, tmp_path):
    seen = {}
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: seen.__setitem__(k, v))
    assert cache.enable_compile_cache() == str(tmp_path)
    assert seen == {}


def test_cached_keyset_round_trip(tmp_path):
    from ieache import params as P

    path = str(tmp_path / "k" / "tiny_.iek")
    made = keygen.cached_keyset(P.TEST_TINY, keygen.MAIN_SEED, path)
    assert os.path.exists(path)
    loaded = keygen.cached_keyset(P.TEST_TINY, keygen.MAIN_SEED, path)
    np.testing.assert_array_equal(loaded.cloud.bk, made.cloud.bk)
    np.testing.assert_array_equal(loaded.lwe_key.s, made.lwe_key.s)


def _run_cpu(cmd, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("BENCH_FORCE_CPU", None)
    return subprocess.run([sys.executable, *cmd], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_cpu():
    out = _run_cpu(["chip_smoke.py"], REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run_cpu(["chip_smoke.py"], str(tmp_path))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_bench_refuses_cpu_without_opt_in():
    out = _run_cpu(["bench.py"], REPO)
    assert out.returncode != 0
    assert "needs a GPU" in out.stderr
    assert not out.stdout.strip()
