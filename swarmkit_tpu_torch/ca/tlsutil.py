"""gRPC TLS credential plumbing from a SecurityConfig.

Reference: the reference serves every manager RPC behind one mutual-TLS
listener with VerifyClientCertIfGiven (manager/manager.go:252-270) and
per-RPC authorization from the peer certificate (ca/auth.go:50-120).
python-grpc has no verify-if-given mode (require_client_auth=False never
requests the client certificate), so the same surface splits across three
listeners:

- main port: strict mutual TLS — raft, dispatcher, control, renewal; the
  peer certificate carries identity for per-RPC role checks.
- port+1 (plaintext): ONLY the public root CA certificate, which joiners
  digest-pin against their SWMTKN (the reference fetches this over
  InsecureSkipVerify TLS with the same pin, ca/certificates.go GetRemoteCA).
- port+2 (server-auth TLS): certificate issuance + leader info for
  certificate-less joiners; the join token travels only over TLS.

The port's own copy of the JAX package's ca/tlsutil.py.  It differs in
one place: the server's certificate fetcher hands grpcio a configuration
only when the node's identity changed, and None ("no change") otherwise.
grpcio rebuilds the listener's TLS state on each configuration it is
handed; the JAX package hands it one on every handshake, and under
concurrent handshakes that rebuild crashed daemons with SIGSEGV (grpcio
1.80; the server logging "No match found for server name" just before).
"""

from __future__ import annotations

from typing import Optional

import grpc

from swarmkit_tpu_torch.ca.certificates import TLS_SERVER_NAME


def _cert_config_fetcher(security):
    """(the initial configuration, a fetcher) serving the CURRENT identity
    on every new handshake — a renewed certificate (role flip, root
    rotation) takes effect without restarting the listener (the reference
    gets this from Go's dynamic GetCertificate in its tls.Config;
    python-grpc's equivalent is the certificate configuration fetcher).
    The fetcher returns None while the identity is the one served."""
    def identity():
        return (security.key_pem, security.cert_pem,
                security.root_ca.cert_pem)

    def config(ident):
        key, cert, root = ident
        return grpc.ssl_server_certificate_configuration(
            [(key, cert)], root_certificates=root)

    served = [identity()]

    def fetch():
        now = identity()
        if now == served[0]:
            return None
        served[0] = now
        return config(now)
    return config(served[0]), fetch


def server_credentials(security) -> grpc.ServerCredentials:
    """Strict-mTLS server credentials for the main cluster port: the client
    must present a certificate chaining to the cluster root; per-RPC role
    authorization then reads it (authorize_peer).  DYNAMIC: each handshake
    reads the live SecurityConfig, so renewals and root rotations take
    effect immediately."""
    initial, fetch = _cert_config_fetcher(security)
    return grpc.dynamic_ssl_server_credentials(
        initial, fetch, require_client_authentication=True)


def join_server_credentials(security) -> grpc.ServerCredentials:
    """Server-auth-only TLS for the join port: certificate-less nodes
    verify US (via the digest-pinned root) and send their join token
    encrypted; they cannot present a client certificate yet.  Dynamic for
    the same rotation reasons as server_credentials."""
    initial, fetch = _cert_config_fetcher(security)
    return grpc.dynamic_ssl_server_credentials(
        initial, fetch, require_client_authentication=False)


def channel_credentials(security=None,
                        pinned_root_pem: Optional[bytes] = None
                        ) -> grpc.ChannelCredentials:
    """Client-side TLS: mutual when we have an identity; server-auth-only
    against a pinned root during the join dance."""
    if security is not None:
        return grpc.ssl_channel_credentials(
            root_certificates=security.root_ca.cert_pem,
            private_key=security.key_pem,
            certificate_chain=security.cert_pem)
    if pinned_root_pem is not None:
        return grpc.ssl_channel_credentials(root_certificates=pinned_root_pem)
    raise ValueError("need a SecurityConfig or a pinned root certificate")


def secure_channel_options(extra: Optional[list] = None) -> list:
    """Node certs carry the constant swarmkit-node SAN; gRPC must check the
    chain against it regardless of the host:port dialed."""
    return [("grpc.ssl_target_name_override", TLS_SERVER_NAME),
            *(extra or ())]


def peer_cert_pem(context) -> Optional[bytes]:
    """The verified peer certificate PEM from a grpc.aio handler context,
    or None when the client connected without one."""
    try:
        auth = context.auth_context()
    except Exception:
        return None
    certs = auth.get("x509_pem_cert") if auth else None
    if not certs:
        return None
    pem = certs[0]
    return pem if isinstance(pem, bytes) else pem.encode()


def authorize_peer(context, security, *allowed_roles: str):
    """Per-RPC authorization from the TLS peer certificate
    (reference: AuthorizeOrgAndRole ca/auth.go). Returns RemoteNodeInfo;
    raises PermissionDenied when no/invalid/wrong-role certificate."""
    from swarmkit_tpu_torch.ca.auth import PermissionDenied, authorize_org_and_role

    pem = peer_cert_pem(context)
    if pem is None:
        raise PermissionDenied("no client certificate presented")
    return authorize_org_and_role(pem, security.root_ca, security.org,
                                  *allowed_roles)
