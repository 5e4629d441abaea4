"""Per-RPC role authorization from the presented certificate.

Reference: ca/auth.go (247 LoC) — AuthorizeOrgAndRole checks the TLS peer
certificate's OU against the roles an RPC admits; RemoteNode extracts the
caller identity (with ForwardedBy for raft-proxied requests).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from swarmkit_tpu_torch.ca.certificates import (
    CertificateError, RootCA, parse_identity,
)


class PermissionDenied(Exception):
    pass


@dataclass
class RemoteNodeInfo:
    """reference: ca/auth.go RemoteNodeInfo."""

    node_id: str
    role_ou: str
    org: str
    forwarded_by: Optional[str] = None


def authorize_org_and_role(cert_pem: bytes, root_ca: RootCA, org: str,
                           *allowed_roles: str) -> RemoteNodeInfo:
    """Validate the chain, the org, and the role OU
    (reference: AuthorizeOrgAndRole ca/auth.go)."""
    try:
        root_ca.validate_cert_chain(cert_pem)
    except CertificateError as e:
        raise PermissionDenied(f"invalid certificate: {e}")
    node_id, role_ou, cert_org = parse_identity(cert_pem)
    if org and cert_org != org:
        raise PermissionDenied(
            f"certificate from organization {cert_org!r} rejected")
    if allowed_roles and role_ou not in allowed_roles:
        raise PermissionDenied(
            f"role {role_ou!r} not allowed (need one of {allowed_roles})")
    return RemoteNodeInfo(node_id=node_id, role_ou=role_ou, org=cert_org)
