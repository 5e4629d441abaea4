"""External CA signer: delegate node-certificate signing to an HTTPS
CFSSL-protocol endpoint.

Reference: ca/external.go:1-230 — ExternalCA posts a CFSSL sign request
(JSON ``{"certificate_request": "<csr pem>"}``) to the configured URL over
TLS and expects ``{"success": true, "result": {"certificate": "<pem>"}}``;
the returned leaf must chain to the cluster root. Used when the cluster
spec configures ExternalCAs and the local RootCA has no signing key
(certificate authority held outside the cluster).

The HTTP round trip runs in a worker thread (stdlib urllib, no extra
dependencies); the external endpoint is authenticated by pinning its CA
certificate from the ExternalCA spec entry.
"""

from __future__ import annotations

import asyncio
import json
import logging
import ssl
import urllib.request
from typing import Optional, Sequence

from swarmkit_tpu_torch.ca.certificates import (
    CertificateError, IssuedCertificate, RootCA,
)

log = logging.getLogger("swarmkit_tpu_torch.ca.external")

PROTOCOL_CFSSL = "cfssl"


class ExternalCAError(Exception):
    pass


class ExternalCAClient:
    """Round-robin CFSSL signer over the cluster's configured external CAs
    (reference: ExternalCA external.go; request shape signNodeCertificate).
    """

    def __init__(self, cas: Sequence, cluster_root: RootCA,
                 timeout: float = 10.0) -> None:
        self.cas = [ca for ca in cas
                    if ca.protocol == PROTOCOL_CFSSL and ca.url]
        self.cluster_root = cluster_root
        self.timeout = timeout

    @property
    def configured(self) -> bool:
        return bool(self.cas)

    def _post(self, ca, payload: bytes) -> dict:
        ctx: Optional[ssl.SSLContext] = None
        if ca.url.startswith("https"):
            ctx = ssl.create_default_context()
            if ca.ca_cert:
                ctx.load_verify_locations(cadata=ca.ca_cert.decode())
        req = urllib.request.Request(
            ca.url, data=payload,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=self.timeout,
                                    context=ctx) as resp:
            return json.loads(resp.read())

    async def sign(self, csr_pem: bytes, node_id: str, role_ou: str,
                   org: str) -> IssuedCertificate:
        """Sign a CSR via the first healthy external CA; the result MUST
        chain to the cluster root (external.go CrossSign validation). The
        request carries the swarm identity subject the signer must emboss
        (reference: external.go signNodeCertificate request shape)."""
        if not self.configured:
            raise ExternalCAError("no external CA configured")
        from swarmkit_tpu_torch.ca.certificates import TLS_SERVER_NAME

        payload = json.dumps({
            "certificate_request": csr_pem.decode(),
            "subject": {"CN": node_id,
                        "names": [{"OU": role_ou, "O": org}]},
            "hosts": [TLS_SERVER_NAME, node_id],
        }).encode()
        loop = asyncio.get_running_loop()
        last: Optional[Exception] = None
        for ca in self.cas:
            try:
                body = await loop.run_in_executor(
                    None, self._post, ca, payload)
                if not body.get("success"):
                    raise ExternalCAError(
                        f"external CA refused: {body.get('errors')}")
                cert_pem = body["result"]["certificate"].encode()
                self.cluster_root.validate_cert_chain(cert_pem)
                return IssuedCertificate(cert_pem=cert_pem, key_pem=None)
            except (ExternalCAError, CertificateError):
                raise
            except Exception as e:
                last = e
                log.warning("external CA %s failed: %s", ca.url, e)
        raise ExternalCAError(f"all external CAs failed: {last}")
