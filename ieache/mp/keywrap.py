"""AES-256-CBC file wrapping for key material ("*.hacklab" files).

Byte-compatible re-implementation of the reference's
``encrypting()``/``decrypting()`` helpers
(``/root/reference/Keygen/dragonfly_private_keygen.py:527-546`` /
``Client1/dragonfly_private_client.py:529-546``): the PMK from the
Dragonfly handshake keys an AES-256-CBC stream with a 16-char ASCII
file-size header, a 16-byte IV prefix, 64 KiB chunking and space
padding; wrapped files carry the ``.hacklab`` suffix.

The cipher is the native library's AES-256-CBC (``native/src/aes.cc``),
so the key plane needs no Python crypto package.
"""

from __future__ import annotations

import os
import secrets

from ieache.native.lib import aes256_cbc

SUFFIX = ".hacklab"


def encrypt_bytes(key: bytes, data: bytes, iv: bytes | None = None) -> bytes:
    """-> 16-char size header + IV + CBC ciphertext (space padded)."""
    if len(key) != 32:
        raise ValueError("AES-256 key must be 32 bytes")
    iv = iv or secrets.token_bytes(16)
    header = "{:016d}".format(len(data)).encode()
    # the reference pads only its last 64 KiB chunk, so CBC over the
    # space-padded whole is the same stream
    padded = data + b" " * (-len(data) % 16)
    return header + iv + aes256_cbc(key, iv, padded)


def decrypt_bytes(key: bytes, blob: bytes) -> bytes:
    size = int(blob[:16].decode())
    iv = blob[16:32]
    return aes256_cbc(key, iv, blob[32:], decrypt=True)[:size]


def encrypt_file(key: bytes, filename: str, out: str | None = None) -> str:
    """filename -> filename + '.hacklab' (reference convention)."""
    out = out or filename + SUFFIX
    with open(filename, "rb") as f:
        data = f.read()
    with open(out, "wb") as f:
        f.write(encrypt_bytes(key, data))
    return out


def decrypt_file(key: bytes, filename: str, out: str | None = None) -> str:
    if out is None:
        out = filename[: -len(SUFFIX)] if filename.endswith(SUFFIX) \
            else filename + ".plain"
    with open(filename, "rb") as f:
        blob = f.read()
    with open(out, "wb") as f:
        f.write(decrypt_bytes(key, blob))
    return out


def new_iv() -> bytes:
    return secrets.token_bytes(16)


def file_md5(path: str) -> str:
    """md5 digest hex — the reference's manual transfer cross-check
    (`dragonfly_private_keygen.py:676-680`)."""
    import hashlib

    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()
