"""At-rest encryption for raft WAL/snapshots and TLS keys.

Behavioral reference: manager/encryption/encryption.go — the
``MaybeEncryptedRecord`` envelope (algorithm + data + nonce), a default
authenticated-secretbox algorithm, a FIPS-friendly fernet alternative, and a
``MultiDecrypter`` so key rotation can decrypt records written under either
the old or the new key.

Re-expression: instead of NaCl secretbox we use ChaCha20-Poly1305
(the same AEAD family) from the ``cryptography`` package, which is what this
environment ships.  Envelope wire format is msgpack.

The port's own copy of the JAX package's encryption/encryption.py; the
envelope packs with raft/wire.py's msgpack-equal codec.  The branch is
chosen at import, as there: with the ``cryptography`` package the
algorithms are ChaCha20-Poly1305 and Fernet; without it, the stand-in
AEAD below (SHA-256-CTR keystream and a truncated HMAC-SHA256 tag).
Records one branch writes are readable only by that branch, in either
package: a WAL encrypted where ``cryptography`` is installed does not
decrypt where it is not, and the reverse.
"""

from __future__ import annotations

import base64
import enum
import os
from dataclasses import dataclass, field
from typing import Iterable, Optional

import hashlib
import hmac as _hmac

from swarmkit_tpu_torch.raft.wire import packb, unpackb

try:
    from cryptography.fernet import Fernet, InvalidToken
    from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305
    HAVE_CRYPTOGRAPHY = True
except ImportError:  # pragma: no cover - depends on the environment
    HAVE_CRYPTOGRAPHY = False

    class InvalidToken(Exception):
        pass

    class _HashlibAead:
        """Stand-in AEAD when the ``cryptography`` package is absent:
        SHA-256-CTR keystream + truncated HMAC-SHA256 tag, domain-separated
        per algorithm.  Same encrypt/decrypt surface as ChaCha20Poly1305.
        Records it writes are only readable by this fallback (and vice
        versa) — fine for a self-contained store, not for interop."""

        _TAG = 16

        def __init__(self, key: bytes, domain: bytes) -> None:
            self._key = key
            self._domain = domain

        def _stream(self, nonce: bytes, n: int) -> bytes:
            out = bytearray()
            ctr = 0
            while len(out) < n:
                out += hashlib.sha256(
                    self._domain + self._key + nonce
                    + ctr.to_bytes(8, "big")).digest()
                ctr += 1
            return bytes(out[:n])

        def _mac(self, nonce: bytes, ct: bytes) -> bytes:
            return _hmac.new(self._key, self._domain + nonce + ct,
                             hashlib.sha256).digest()[:self._TAG]

        def encrypt(self, nonce: bytes, data: bytes, aad: bytes) -> bytes:
            ct = bytes(a ^ b for a, b in
                       zip(data, self._stream(nonce, len(data))))
            return ct + self._mac(nonce, ct)

        def decrypt(self, nonce: bytes, data: bytes, aad: bytes) -> bytes:
            if len(data) < self._TAG:
                raise InvalidToken("ciphertext too short")
            ct, tag = data[:-self._TAG], data[-self._TAG:]
            if not _hmac.compare_digest(tag, self._mac(nonce, ct)):
                raise InvalidToken("tag mismatch")
            return bytes(a ^ b for a, b in
                         zip(ct, self._stream(nonce, len(ct))))

    def ChaCha20Poly1305(key: bytes):  # noqa: N802 - drop-in name
        return _HashlibAead(key, b"secretbox:")

    class Fernet:
        """Token-level stand-in for ``cryptography.fernet.Fernet`` backed
        by the same hashlib AEAD (nonce is prepended to the token)."""

        def __init__(self, b64_key: bytes) -> None:
            self._aead = _HashlibAead(base64.urlsafe_b64decode(b64_key),
                                      b"fernet:")

        def encrypt(self, data: bytes) -> bytes:
            nonce = os.urandom(16)
            return nonce + self._aead.encrypt(nonce, data, b"")

        def decrypt(self, token: bytes) -> bytes:
            if len(token) < 16:
                raise InvalidToken("token too short")
            return self._aead.decrypt(token[:16], token[16:], b"")


class Algorithm(enum.IntEnum):
    NONE = 0
    SECRETBOX = 1   # ChaCha20-Poly1305 AEAD (NaCl-secretbox analog)
    FERNET = 2      # AES128-CBC + HMAC (FIPS-friendly, like the reference)


@dataclass
class MaybeEncryptedRecord:
    """Envelope around possibly-encrypted bytes
    (reference: api/types.proto MaybeEncryptedRecord)."""

    algorithm: Algorithm = Algorithm.NONE
    data: bytes = b""
    nonce: bytes = b""

    def encode(self) -> bytes:
        return packb((int(self.algorithm), self.data, self.nonce))

    @classmethod
    def decode(cls, raw: bytes) -> "MaybeEncryptedRecord":
        alg, data, nonce = unpackb(raw)
        return cls(Algorithm(alg), data, nonce)


class DecryptError(Exception):
    pass


class Encrypter:
    def encrypt(self, data: bytes) -> MaybeEncryptedRecord:
        raise NotImplementedError


class Decrypter:
    algorithm: Algorithm = Algorithm.NONE

    def decrypt(self, rec: MaybeEncryptedRecord) -> bytes:
        raise NotImplementedError


class NopCrypter(Encrypter, Decrypter):
    """Passthrough (reference: NoopCrypter)."""

    algorithm = Algorithm.NONE

    def encrypt(self, data: bytes) -> MaybeEncryptedRecord:
        return MaybeEncryptedRecord(Algorithm.NONE, data, b"")

    def decrypt(self, rec: MaybeEncryptedRecord) -> bytes:
        if rec.algorithm != Algorithm.NONE:
            raise DecryptError("record is encrypted; nop decrypter")
        return rec.data


class SecretboxCrypter(Encrypter, Decrypter):
    """Default AEAD crypter keyed by a 32-byte secret
    (reference: NACLSecretbox, encryption.go)."""

    algorithm = Algorithm.SECRETBOX

    def __init__(self, key: bytes) -> None:
        if len(key) != 32:
            raise ValueError("secretbox key must be 32 bytes")
        self._aead = ChaCha20Poly1305(key)

    def encrypt(self, data: bytes) -> MaybeEncryptedRecord:
        nonce = os.urandom(12)
        return MaybeEncryptedRecord(
            Algorithm.SECRETBOX, self._aead.encrypt(nonce, data, b""), nonce)

    def decrypt(self, rec: MaybeEncryptedRecord) -> bytes:
        if rec.algorithm != Algorithm.SECRETBOX:
            raise DecryptError(f"not a secretbox record: {rec.algorithm}")
        try:
            return self._aead.decrypt(rec.nonce, rec.data, b"")
        except Exception as e:  # InvalidTag
            raise DecryptError(str(e)) from e


class FernetCrypter(Encrypter, Decrypter):
    """FIPS-friendly alternative (reference: Fernet in encryption.go)."""

    algorithm = Algorithm.FERNET

    def __init__(self, key: bytes) -> None:
        if len(key) != 32:
            raise ValueError("fernet key must be 32 bytes")
        self._f = Fernet(base64.urlsafe_b64encode(key))

    def encrypt(self, data: bytes) -> MaybeEncryptedRecord:
        return MaybeEncryptedRecord(Algorithm.FERNET, self._f.encrypt(data), b"")

    def decrypt(self, rec: MaybeEncryptedRecord) -> bytes:
        if rec.algorithm != Algorithm.FERNET:
            raise DecryptError(f"not a fernet record: {rec.algorithm}")
        try:
            return self._f.decrypt(rec.data)
        except InvalidToken as e:
            raise DecryptError("invalid fernet token") from e


class MultiDecrypter(Decrypter):
    """Tries each decrypter whose algorithm matches
    (reference: NewMultiDecrypter encryption.go:104)."""

    def __init__(self, *decrypters: Decrypter) -> None:
        # Flatten nested MultiDecrypters: a Multi has no `.algorithm` of
        # its own, so as a MEMBER it would never match any record and its
        # whole chain would be silently skipped (observed: DEK rotation
        # composing Multi(new, old_multi) losing the old generations).
        flat: list[Decrypter] = []
        for d in decrypters:
            if d is None:
                continue
            if isinstance(d, MultiDecrypter):
                flat.extend(d._decrypters)
            else:
                flat.append(d)
        self._decrypters = flat

    def decrypt(self, rec: MaybeEncryptedRecord) -> bytes:
        last: Optional[Exception] = None
        for d in self._decrypters:
            if d.algorithm == rec.algorithm:
                try:
                    return d.decrypt(rec)
                except DecryptError as e:
                    last = e
        raise DecryptError(
            f"no decrypter succeeded for algorithm {rec.algorithm}"
            + (f": {last}" if last else ""))


def defaults(key: Optional[bytes], fips: bool = False
             ) -> tuple[Encrypter, Decrypter]:
    """Default encrypter/decrypter pair for a key
    (reference: Defaults encryption.go:156)."""
    if key is None:
        nop = NopCrypter()
        return nop, nop
    if fips:
        f = FernetCrypter(key)
        return f, MultiDecrypter(f)
    s = SecretboxCrypter(key)
    return s, MultiDecrypter(s, FernetCrypter(key))


def generate_secret_key() -> bytes:
    return os.urandom(32)


def human_readable_key(key: bytes) -> str:
    return base64.b64encode(key).decode("ascii")


def parse_human_readable_key(s: str) -> bytes:
    key = base64.b64decode(s)
    if len(key) != 32:
        raise ValueError("key must decode to 32 bytes")
    return key
