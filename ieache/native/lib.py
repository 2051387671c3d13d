"""ctypes bindings for the native library (libieache_oracle.so): the
C++ oracle (src/oracle.cc), brainpool EC arithmetic (src/ec.cc) and
AES-256-CBC (src/aes.cc).

Built on first use with `make`, or, where `make` is missing, by calling
the C++ compiler on the same sources.  No external dependencies.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

from ieache.params import TFHEParams

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "libieache_oracle.so")
_lib = None


def _build():
    import shutil

    if shutil.which("make"):
        subprocess.run(["make", "-C", _DIR], check=True, capture_output=True)
        return
    srcs = sorted(os.path.join(_DIR, "src", f)
                  for f in os.listdir(os.path.join(_DIR, "src"))
                  if f.endswith(".cc"))
    subprocess.run(
        [os.environ.get("CXX", "g++"), "-O2", "-fPIC", "-shared",
         "-std=c++17", "-o", _SO, *srcs],
        check=True, capture_output=True,
    )


def get_lib():
    global _lib
    if _lib is not None:
        return _lib
    newest_src = max(
        os.path.getmtime(os.path.join(_DIR, "src", f))
        for f in os.listdir(os.path.join(_DIR, "src"))
        if f.endswith(".cc")
    )
    if not os.path.exists(_SO) or os.path.getmtime(_SO) < newest_src:
        _build()
    lib = ctypes.CDLL(_SO)
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    lib.tf_threefry.argtypes = [
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_uint32, u32p,
    ]
    lib.tf_random_bits.argtypes = [
        ctypes.c_uint32, ctypes.c_uint32, u32p, ctypes.c_int64,
    ]
    lib.tf_keygen.argtypes = [
        i32p, u32p, ctypes.c_int, i32p, i32p, i32p, i32p,
    ]
    lib.tf_encrypt.argtypes = [
        i32p, i32p, i32p, ctypes.c_int64, ctypes.c_uint32,
        ctypes.c_uint32, i32p,
    ]
    lib.tf_decrypt.argtypes = [i32p, i32p, i32p, ctypes.c_int64, i32p]
    lib.tf_bootstrap.argtypes = [
        i32p, i32p, i32p, i32p, ctypes.c_int64, ctypes.c_int32, i32p,
    ]
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.ec_mul.argtypes = [u8p, u8p, u8p, u8p, u8p]
    lib.ec_mul.restype = ctypes.c_int
    for fn in (lib.aes256_cbc_encrypt, lib.aes256_cbc_decrypt):
        fn.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
                       ctypes.c_char_p, ctypes.c_int64]
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def ec_mul(scalar: int, x: int, y: int):
    """Native brainpool scalar multiplication (releases the GIL).

    Returns (x, y) ints, or None for the point at infinity."""
    lib = get_lib()
    buf = (ctypes.c_uint8 * 160)()
    buf[0:32] = scalar.to_bytes(32, "big")
    buf[32:64] = x.to_bytes(32, "big")
    buf[64:96] = y.to_bytes(32, "big")
    p = ctypes.cast(buf, ctypes.POINTER(ctypes.c_uint8))
    rc = lib.ec_mul(
        p,
        ctypes.cast(ctypes.byref(buf, 32), ctypes.POINTER(ctypes.c_uint8)),
        ctypes.cast(ctypes.byref(buf, 64), ctypes.POINTER(ctypes.c_uint8)),
        ctypes.cast(ctypes.byref(buf, 96), ctypes.POINTER(ctypes.c_uint8)),
        ctypes.cast(ctypes.byref(buf, 128), ctypes.POINTER(ctypes.c_uint8)),
    )
    if rc:
        return None
    return (
        int.from_bytes(bytes(buf[96:128]), "big"),
        int.from_bytes(bytes(buf[128:160]), "big"),
    )


def aes256_cbc(key: bytes, iv: bytes, data: bytes, decrypt: bool = False
               ) -> bytes:
    """AES-256-CBC over whole 16-byte blocks, no padding."""
    if len(key) != 32 or len(iv) != 16:
        raise ValueError("AES-256-CBC needs a 32-byte key and a 16-byte IV")
    lib = get_lib()
    out = ctypes.create_string_buffer(len(data))
    fn = lib.aes256_cbc_decrypt if decrypt else lib.aes256_cbc_encrypt
    if fn(key, iv, data, out, len(data)):
        raise ValueError("AES-CBC input must be a multiple of 16 bytes")
    return out.raw


def params_array(p: TFHEParams) -> np.ndarray:
    return np.array(
        [p.n, p.N, p.k, p.bg_bit, p.l, p.ks_basebit, p.ks_t,
         p.lwe_noise_scale, p.tlwe_noise_scale, p.noise_bits],
        dtype=np.int32,
    )


# -- high-level wrappers ----------------------------------------------------

def oracle_keygen(p: TFHEParams, seed_words):
    lib = get_lib()
    pr = params_array(p)
    seeds = np.asarray(seed_words, np.uint32)
    lwe_s = np.zeros(p.n, np.int32)
    trlwe_k = np.zeros(p.k * p.N, np.int32)
    bk = np.zeros(p.n * p.trgsw_rows * (p.k + 1) * p.N, np.int32)
    ks = np.zeros(p.kN * p.ks_t * (p.n + 1), np.int32)
    lib.tf_keygen(pr, seeds, len(seeds), lwe_s, trlwe_k, bk, ks)
    return (
        lwe_s,
        trlwe_k.reshape(p.k, p.N),
        bk.reshape(p.n, p.trgsw_rows, p.k + 1, p.N),
        ks.reshape(p.kN * p.ks_t, p.n + 1),
    )


def oracle_encrypt(p: TFHEParams, lwe_s, bits, stream_key):
    lib = get_lib()
    bits = np.ascontiguousarray(bits, np.int32).reshape(-1)
    out = np.zeros(len(bits) * (p.n + 1), np.int32)
    lib.tf_encrypt(
        params_array(p), np.ascontiguousarray(lwe_s, np.int32), bits,
        len(bits), int(stream_key[0]), int(stream_key[1]), out,
    )
    return out.reshape(len(bits), p.n + 1)


def oracle_decrypt(p: TFHEParams, lwe_s, lwe):
    lib = get_lib()
    lwe = np.ascontiguousarray(lwe, np.int32)
    nrows = lwe.shape[0]
    bits = np.zeros(nrows, np.int32)
    lib.tf_decrypt(
        params_array(p), np.ascontiguousarray(lwe_s, np.int32),
        lwe.reshape(-1), nrows, bits,
    )
    return bits


def oracle_bootstrap(p: TFHEParams, bk, ks, lwe_in, mu=1 << 29):
    lib = get_lib()
    lwe_in = np.ascontiguousarray(lwe_in, np.int32)
    nrows = lwe_in.shape[0]
    out = np.zeros(nrows * (p.n + 1), np.int32)
    lib.tf_bootstrap(
        params_array(p),
        np.ascontiguousarray(bk, np.int32).reshape(-1),
        np.ascontiguousarray(ks, np.int32).reshape(-1),
        lwe_in.reshape(-1), nrows, np.int32(mu), out,
    )
    return out.reshape(nrows, p.n + 1)
