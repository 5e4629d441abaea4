"""At-rest storage for the node's TLS material, with optional KEK
encryption of the private key (cluster autolock).

Reference: ca/keyreadwriter.go (493 LoC) — cert.pem / key.pem under
<state>/certificates/, the key optionally PEM-encrypted with the kek, and
PEM headers on the key carrying rotation state (the raft DEK).  Here the
key, its encryption flag, and the headers live in ONE json envelope
written atomically — a KEK rotation flips all of them in a single rename,
so no crash can leave the key and its headers sealed under different
KEKs (the reference gets the same atomicity from headers living inside
the key PEM).
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
from typing import Optional

try:
    from cryptography.fernet import Fernet, InvalidToken
except ImportError:  # pragma: no cover - depends on the environment
    # kek-sealed key storage falls back to the hashlib-backed Fernet
    # stand-in (swarmkit_tpu_torch.encryption); plaintext storage is unaffected.
    from swarmkit_tpu_torch.encryption.encryption import Fernet, InvalidToken


class KeyReadWriter:
    def __init__(self, cert_dir: str, kek: Optional[bytes] = None) -> None:
        self.cert_dir = cert_dir
        self._kek = kek
        os.makedirs(cert_dir, exist_ok=True)

    @property
    def cert_path(self) -> str:
        return os.path.join(self.cert_dir, "swarm-node.crt")

    @property
    def key_path(self) -> str:
        return os.path.join(self.cert_dir, "swarm-node.key")

    @property
    def root_ca_path(self) -> str:
        return os.path.join(self.cert_dir, "swarm-root-ca.crt")

    # ------------------------------------------------------------------
    def _fernet(self, kek: bytes) -> Fernet:
        return Fernet(base64.urlsafe_b64encode(
            hashlib.sha256(kek).digest()))

    def set_kek(self, kek: Optional[bytes]) -> bool:
        """Re-encrypt the stored key AND headers under a new kek in ONE
        atomic envelope write; no-op (returns False) when it is already in
        effect (reference: RotateKEK keyreadwriter.go)."""
        if kek == self._kek:
            return False
        env = self._load()
        key = self._open_key(env) if env else None
        headers = self._open_headers(env) if env else {}
        self._kek = kek
        if env is not None:
            self._store(key, headers)
        return True

    # -- the key envelope ------------------------------------------------
    # swarm-node.key holds {"v": 1, "key": b64, "encrypted": bool,
    # "headers": {name: {"v": b64, "encrypted": bool}}} — key and headers
    # always flip KEKs together.
    def _load(self) -> Optional[dict]:
        if not os.path.exists(self.key_path):
            return None
        raw = open(self.key_path, "rb").read()
        if raw[:1] == b"{":
            return json.loads(raw)
        # legacy layout: raw payload + .meta / .headers sidecars
        meta = {"encrypted": False}
        if os.path.exists(self.key_path + ".meta"):
            meta = json.loads(open(self.key_path + ".meta").read())
        headers = {}
        legacy_headers = os.path.join(self.cert_dir, "swarm-node.headers")
        if os.path.exists(legacy_headers):
            headers = json.loads(open(legacy_headers).read())
        return {"v": 1, "key": base64.b64encode(raw).decode(),
                "encrypted": bool(meta.get("encrypted")),
                "headers": headers}

    def _open_key(self, env: dict) -> bytes:
        payload = base64.b64decode(env["key"])
        if env.get("encrypted"):
            if not self._kek:
                raise PermissionError(
                    "node key is locked; unlock key required")
            try:
                payload = self._fernet(self._kek).decrypt(payload)
            except InvalidToken:
                raise PermissionError("invalid unlock key")
        return payload

    def _open_headers(self, env: dict) -> dict[str, bytes]:
        out: dict[str, bytes] = {}
        for name, entry in env.get("headers", {}).items():
            raw = base64.b64decode(entry["v"])
            if entry.get("encrypted"):
                if not self._kek:
                    raise PermissionError(
                        f"header {name} is locked; unlock key required")
                try:
                    raw = self._fernet(self._kek).decrypt(raw)
                except InvalidToken:
                    raise PermissionError("invalid unlock key (headers)")
            out[name] = raw
        return out

    def _store(self, key_pem: bytes, headers: dict[str, bytes]) -> None:
        enc = bool(self._kek)
        payload = self._fernet(self._kek).encrypt(key_pem) if enc \
            else key_pem
        blob = {}
        for name, value in headers.items():
            sealed = self._fernet(self._kek).encrypt(value) if enc else value
            blob[name] = {"v": base64.b64encode(sealed).decode(),
                          "encrypted": enc}
        env = {"v": 1, "key": base64.b64encode(payload).decode(),
               "encrypted": enc, "headers": blob}
        self._atomic(self.key_path, json.dumps(env).encode(), mode=0o600)
        for legacy in (self.key_path + ".meta",
                       os.path.join(self.cert_dir, "swarm-node.headers")):
            if os.path.exists(legacy):
                os.unlink(legacy)

    # -- raft DEK accessors (reference: manager/deks.go RaftDEKData — the
    # DEK generations ride the key headers so the KEK protects them) -----
    def get_raft_deks(self) -> tuple[Optional[bytes], list[bytes]]:
        """(current DEK, older generations still present in the log)."""
        h = self.get_headers()
        cur = h.get("raft_dek")
        hist = [base64.b64decode(x)
                for x in json.loads(h["raft_dek_history"].decode())] \
            if h.get("raft_dek_history") else []
        return cur, hist

    def set_raft_deks(self, current: bytes, history: list[bytes]) -> None:
        h = self.get_headers()
        h["raft_dek"] = current
        h["raft_dek_history"] = json.dumps(
            [base64.b64encode(x).decode() for x in history]).encode()
        self.set_headers(h)

    def is_encrypted(self) -> bool:
        env = self._load()
        return bool(env and env.get("encrypted"))

    def get_headers(self) -> dict[str, bytes]:
        env = self._load()
        return self._open_headers(env) if env else {}

    def set_headers(self, headers: dict[str, bytes]) -> None:
        env = self._load()
        key = self._open_key(env) if env else b""
        self._store(key, headers)

    # ------------------------------------------------------------------
    def write(self, cert_pem: bytes, key_pem: bytes) -> None:
        env = self._load()
        headers = self._open_headers(env) if env else {}
        self._atomic(self.cert_path, cert_pem)
        self._store(key_pem, headers)

    def read(self) -> tuple[Optional[bytes], Optional[bytes]]:
        env = self._load()
        if not os.path.exists(self.cert_path) or env is None:
            return None, None
        cert = open(self.cert_path, "rb").read()
        return cert, self._open_key(env)

    def write_root_ca(self, cert_pem: bytes) -> None:
        self._atomic(self.root_ca_path, cert_pem)

    def read_root_ca(self) -> Optional[bytes]:
        if not os.path.exists(self.root_ca_path):
            return None
        return open(self.root_ca_path, "rb").read()

    @staticmethod
    def _atomic(path: str, data: bytes, mode: int = 0o644) -> None:
        """reference: ioutils.AtomicWriteFile.  ``mode`` applies from the
        first byte (keys must never exist world-readable, even as .tmp)."""
        tmp = path + ".tmp"
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, mode)
        os.fchmod(fd, mode)  # O_CREAT mode is skipped if tmp pre-exists
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
