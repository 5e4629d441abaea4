"""SecurityConfig, join tokens, and certificate renewal.

Reference: ca/config.go (721 LoC) — SecurityConfig holds the live TLS state
(root + node certificate + derived identity) with an update queue;
GenerateJoinToken / ParseJoinToken encode the CA digest + a secret into
``SWMTKN-1-<digest>-<secret>``; RenewTLSConfig (via ca/renewer.go
TLSRenewer) renews the node certificate at ~half life with jitter and
backoff.
"""

from __future__ import annotations

import asyncio
import logging
import random
import secrets as pysecrets
from dataclasses import dataclass
from typing import Optional

from swarmkit_tpu_torch.ca.certificates import (
    MANAGER_ROLE_OU, WORKER_ROLE_OU, RootCA, parse_identity,
)
from swarmkit_tpu_torch.utils.clock import Clock, SystemClock
from swarmkit_tpu_torch.watch.queue import Queue

log = logging.getLogger("swarmkit_tpu_torch.ca")


class InvalidJoinToken(Exception):
    pass


def generate_join_token(root_ca: RootCA, secret: Optional[str] = None) -> str:
    """``SWMTKN-1-<ca digest>-<secret>``
    (reference: ca/config.go GenerateJoinToken)."""
    return "SWMTKN-1-%s-%s" % (root_ca.digest(),
                               secret or pysecrets.token_hex(16))


@dataclass
class ParsedToken:
    version: int
    ca_digest: str
    secret: str


def pinned_cert(root_pem: bytes, token: str) -> Optional[bytes]:
    """The ONE certificate in a served (possibly old+new rotation) bundle
    whose digest matches the join token's pin, or None.  Only the pinned
    member may be trusted from an UNAUTHENTICATED fetch — trusting the
    whole bundle would let a MITM smuggle a rogue root alongside the real
    one (reference: GetRemoteCA digest verification).  The full rotation
    bundle is installed later from the ISSUANCE response, which arrives
    over a channel verified against this pinned cert."""
    import hmac

    from swarmkit_tpu_torch.ca.certificates import split_bundle

    want = parse_join_token(token).ca_digest
    for cert_pem, digest in split_bundle(root_pem):
        if hmac.compare_digest(digest, want):
            return cert_pem
    return None


def verify_root_digest(root_pem: bytes, token: str) -> bool:
    """True when the join token's pin matches a member of the served
    bundle (see pinned_cert — callers needing trust material should use
    that and trust ONLY the returned cert)."""
    return pinned_cert(root_pem, token) is not None


def parse_join_token(token: str) -> ParsedToken:
    """reference: ca/config.go ParseJoinToken."""
    parts = token.split("-")
    if len(parts) != 4 or parts[0] != "SWMTKN":
        raise InvalidJoinToken("invalid join token format")
    if parts[1] != "1":
        raise InvalidJoinToken(f"unsupported join token version {parts[1]}")
    return ParsedToken(version=1, ca_digest=parts[2], secret=parts[3])


@dataclass
class SecurityUpdate:
    role: str


class SecurityConfig:
    """Live TLS identity (reference: ca.SecurityConfig ca/config.go)."""

    def __init__(self, root_ca: RootCA, node_id: str, role_ou: str,
                 org: str, cert_pem: bytes, key_pem: bytes) -> None:
        self.root_ca = root_ca
        self.node_id = node_id
        self.role_ou = role_ou
        self.org = org
        self.cert_pem = cert_pem
        self.key_pem = key_pem
        self.updates = Queue()

    @property
    def is_manager(self) -> bool:
        return self.role_ou == MANAGER_ROLE_OU

    def update_cert(self, cert_pem: bytes, key_pem: bytes) -> None:
        node_id, role_ou, org = parse_identity(cert_pem)
        role_changed = role_ou != self.role_ou
        self.cert_pem = cert_pem
        self.key_pem = key_pem
        self.node_id = node_id
        self.role_ou = role_ou
        self.org = org
        if role_changed:
            self.updates.publish(SecurityUpdate(role=role_ou))

    def validity_remaining(self, now_utc=None) -> float:
        import datetime

        from swarmkit_tpu_torch.ca.certificates import cert_from_pem

        cert = cert_from_pem(self.cert_pem)
        now = now_utc or datetime.datetime.now(datetime.timezone.utc)
        return (cert.not_valid_after_utc - now).total_seconds()


class TLSRenewer:
    """Renews the node certificate before expiry
    (reference: ca/renewer.go TLSRenewer)."""

    def __init__(self, security: SecurityConfig, ca_client,
                 clock: Optional[Clock] = None,
                 rng: Optional[random.Random] = None) -> None:
        self.security = security
        # renewal client protocol: ``await renew_node_certificate(node_id,
        # cert_pem) -> IssuedCertificate`` — a wrapper owning CSR creation
        # and persistence (see node._RenewClient), NOT the raw CAServer
        # (whose renew takes an explicit CSR)
        self.ca_client = ca_client
        self.clock = clock or SystemClock()
        self._rng = rng or random.Random()
        self._task: Optional[asyncio.Task] = None
        self._running = False
        self._wake: Optional[asyncio.Event] = None

    def start(self) -> None:
        self._running = True
        self._wake = asyncio.Event()
        self._task = asyncio.get_running_loop().create_task(self._run())

    def renew_soon(self) -> None:
        """Skip the half-life wait and renew at the next loop step —
        triggered on expected-role changes (a promoted worker needs a
        manager-OU cert NOW, reference: renewer.go SetExpectedRole →
        renew channel) and on certificate-format migrations."""
        if self._wake is not None:
            self._wake.set()

    async def stop(self) -> None:
        self._running = False
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass
            self._task = None

    def _next_delay(self) -> float:
        # renew in [half-life, 80% of life] (reference: calculateRandomExpiry)
        remaining = max(60.0, self.security.validity_remaining())
        return remaining * self._rng.uniform(0.5, 0.8)

    async def _run(self) -> None:
        try:
            while self._running:
                sleeper = asyncio.ensure_future(
                    self.clock.sleep(self._next_delay()))
                waker = asyncio.ensure_future(self._wake.wait())
                try:
                    await asyncio.wait({sleeper, waker},
                                       return_when=asyncio.FIRST_COMPLETED)
                finally:
                    sleeper.cancel()
                    waker.cancel()
                self._wake.clear()
                # retry on the short backoff until the renewal lands —
                # re-entering _next_delay() here would push each retry
                # 50-80% of the remaining validity into the future
                backoff = 1.0
                while self._running:
                    try:
                        await self.renew()
                        break
                    except Exception as e:
                        log.info("certificate renewal failed: %s", e)
                        await self.clock.sleep(backoff)
                        backoff = min(30.0, backoff * 2)
        except asyncio.CancelledError:
            pass

    async def renew(self) -> None:
        """One renewal round trip (reference: RenewTLSConfigNow)."""
        issued = await self.ca_client.renew_node_certificate(
            self.security.node_id, self.security.cert_pem)
        self.security.update_cert(issued.cert_pem,
                                  issued.key_pem or self.security.key_pem)
