"""Model encryption, the port's copy of the JAX package's
``server/security.py``.

``ModelEncryptor`` is AES-256-GCM through OpenSSL's libcrypto (the EVP
interface over ctypes; no Python crypto package), over a chunked container:
``MAGIC``, then per 4 MiB of plaintext a little-endian u32 length, a
12-byte nonce, a 16-byte tag and the ciphertext. The format is the JAX
package's byte for byte: a file either package encrypts, the other
decrypts. ``maybe_decrypt`` is the loader's hook: an encrypted GGUF is
decrypted to a temporary file with the key passed or ``SLT_MODEL_KEY``.
TLS lives in ``server/http.py`` (``Server(tls_cert=, tls_key=)``).
"""

from __future__ import annotations

import contextlib
import ctypes
import ctypes.util
import hashlib
import os
import secrets
import struct
import tempfile

MAGIC = b"SLTENC1\x00"
CHUNK = 1 << 22          # 4 MiB plaintext chunks
KEY_LEN, IV_LEN, TAG_LEN = 32, 12, 16

_crypto = None


def _libcrypto():
    global _crypto
    if _crypto is None:
        name = ctypes.util.find_library("crypto") or "libcrypto.so.3"
        _crypto = ctypes.CDLL(name)
        _crypto.EVP_CIPHER_CTX_new.restype = ctypes.c_void_p
        _crypto.EVP_aes_256_gcm.restype = ctypes.c_void_p
    return _crypto


class _GCM:
    """One EVP_aes_256_gcm operation (encrypt or decrypt)."""

    def __init__(self, key: bytes, iv: bytes, encrypt: bool):
        lib = _libcrypto()
        self.lib = lib
        self.ctx = ctypes.c_void_p(lib.EVP_CIPHER_CTX_new())
        init = lib.EVP_EncryptInit_ex if encrypt else lib.EVP_DecryptInit_ex
        if init(self.ctx, ctypes.c_void_p(lib.EVP_aes_256_gcm()), None,
                key, iv) != 1:
            raise RuntimeError("EVP init failed")
        self.enc = encrypt

    def update(self, data: bytes) -> bytes:
        out = ctypes.create_string_buffer(len(data) + 16)
        outl = ctypes.c_int(0)
        fn = (self.lib.EVP_EncryptUpdate if self.enc
              else self.lib.EVP_DecryptUpdate)
        if fn(self.ctx, out, ctypes.byref(outl), data, len(data)) != 1:
            raise RuntimeError("EVP update failed")
        return out.raw[: outl.value]

    def finish(self, tag: bytes | None = None) -> bytes:
        lib, outl = self.lib, ctypes.c_int(0)
        out = ctypes.create_string_buffer(16)
        if self.enc:
            if lib.EVP_EncryptFinal_ex(self.ctx, out, ctypes.byref(outl)) != 1:
                raise RuntimeError("EVP final failed")
            tag_buf = ctypes.create_string_buffer(TAG_LEN)
            # EVP_CTRL_GCM_GET_TAG = 0x10
            if lib.EVP_CIPHER_CTX_ctrl(self.ctx, 0x10, TAG_LEN, tag_buf) != 1:
                raise RuntimeError("get tag failed")
            result = tag_buf.raw
        else:
            # EVP_CTRL_GCM_SET_TAG = 0x11
            if lib.EVP_CIPHER_CTX_ctrl(self.ctx, 0x11, TAG_LEN, tag) != 1:
                raise RuntimeError("set tag failed")
            if lib.EVP_DecryptFinal_ex(self.ctx, out, ctypes.byref(outl)) != 1:
                raise ValueError("authentication failed (wrong key or corrupt data)")
            result = b""
        lib.EVP_CIPHER_CTX_free(self.ctx)
        self.ctx = None
        return result


def available() -> bool:
    try:
        _libcrypto()
        return True
    except OSError:
        return False


class ModelEncryptor:
    """AES-256-GCM file encryption (llama_model_encryptor counterpart, done
    for real). Key = 32 raw bytes, 64 hex chars, or any passphrase
    (SHA-256-derived, scrypt-free for zero deps)."""

    def __init__(self, key: str | bytes):
        if isinstance(key, bytes) and len(key) == KEY_LEN:
            self.key = key
        else:
            text = key.decode() if isinstance(key, bytes) else key
            try:
                raw = bytes.fromhex(text)
            except ValueError:
                raw = b""
            self.key = raw if len(raw) == KEY_LEN else hashlib.sha256(
                text.encode()).digest()

    def encrypt_file(self, src: str, dst: str) -> None:
        with open(src, "rb") as f, open(dst, "wb") as o:
            o.write(MAGIC)
            while True:
                chunk = f.read(CHUNK)
                if not chunk:
                    break
                iv = secrets.token_bytes(IV_LEN)
                g = _GCM(self.key, iv, encrypt=True)
                ct = g.update(chunk)
                tag = g.finish()
                o.write(struct.pack("<I", len(ct)) + iv + tag + ct)

    def decrypt_file(self, src: str, dst: str) -> None:
        with open(src, "rb") as f, open(dst, "wb") as o:
            if f.read(len(MAGIC)) != MAGIC:
                raise ValueError("not a superllama_tpu encrypted model")
            while True:
                hdr = f.read(4)
                if not hdr:
                    break
                (n,) = struct.unpack("<I", hdr)
                iv = f.read(IV_LEN)
                tag = f.read(TAG_LEN)
                ct = f.read(n)
                g = _GCM(self.key, iv, encrypt=False)
                pt = g.update(ct)
                g.finish(tag)
                o.write(pt)

    @staticmethod
    def is_encrypted(path: str) -> bool:
        with open(path, "rb") as f:
            return f.read(len(MAGIC)) == MAGIC


def maybe_decrypt(path: str, key: str | bytes | None = None) -> str:
    """Loader hook: decrypt an encrypted GGUF to a temporary file (key from
    the argument or ``SLT_MODEL_KEY``) and return its path, which the caller
    removes; any other file's own path. A wrong key raises ValueError and
    leaves no file behind."""
    if not ModelEncryptor.is_encrypted(path):
        return path
    key = key or os.environ.get("SLT_MODEL_KEY")
    if not key:
        raise ValueError(f"{path} is encrypted; set SLT_MODEL_KEY or pass a key")
    fd, tmp = tempfile.mkstemp(suffix=".gguf")
    os.close(fd)
    try:
        ModelEncryptor(key).decrypt_file(path, tmp)
    except BaseException:
        os.unlink(tmp)
        raise
    return tmp


@contextlib.contextmanager
def decrypted(path: str, key: str | bytes | None = None):
    """``maybe_decrypt`` as a context: yields the plain file's path and
    removes a decrypted copy on exit."""
    plain = maybe_decrypt(path, key)
    try:
        yield plain
    finally:
        if plain != path:
            os.unlink(plain)
