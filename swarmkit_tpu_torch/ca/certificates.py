"""Root CA and node certificates: real x509 over ECDSA P-256.

Reference: ca/certificates.go (954 LoC) — RootCA (:170), CreateRootCA
(:771), IssueAndSaveNewCertificates (:202), CrossSignCACertificate (:410).
Identity encoding matches the reference exactly: CN = node id,
OU = role ("swarm-manager" / "swarm-worker"), O = cluster/org id
(ca/certificates.go ManagerRole/WorkerRole constants), so authorization can
be derived from any presented certificate.
"""

from __future__ import annotations

import datetime
import hashlib
from dataclasses import dataclass
from typing import Optional

try:
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID
    HAVE_CRYPTOGRAPHY = True
except ImportError:  # pragma: no cover - depends on the environment
    # x509 certificates cannot be faked in pure python; gate the import so
    # the package (and everything that merely transits it) stays importable
    # and fail at the point of actual use instead.
    HAVE_CRYPTOGRAPHY = False

    class _MissingCryptography:
        def __init__(self, name: str) -> None:
            self._name = name

        def __getattr__(self, attr: str):
            raise ModuleNotFoundError(
                f"{self._name}.{attr} needs the 'cryptography' package, "
                "which is not installed; TLS identities are unavailable")

    x509 = _MissingCryptography("cryptography.x509")
    hashes = _MissingCryptography("cryptography...hashes")
    serialization = _MissingCryptography("cryptography...serialization")
    ec = _MissingCryptography("cryptography...ec")
    NameOID = _MissingCryptography("cryptography...NameOID")

# reference: ca/certificates.go role OU values
MANAGER_ROLE_OU = "swarm-manager"
WORKER_ROLE_OU = "swarm-worker"
CA_ROLE_OU = "swarm-ca"
# Every node cert carries this SAN; gRPC channels override the target name
# to it, so transport-level TLS checks the chain while identity/role checks
# happen against the subject OU/O (reference: swarmkit verifies roles, not
# hostnames — MutualTLS ServerName handling in ca/config.go NewClientTLSConfig).
TLS_SERVER_NAME = "swarmkit-node"

DEFAULT_NODE_CERT_EXPIRATION = 90 * 24 * 3600.0   # ca/certificates.go:60
MIN_NODE_CERT_EXPIRATION = 3600.0
ROOT_CA_EXPIRATION = 20 * 365 * 24 * 3600.0


class CertificateError(Exception):
    pass


def _now() -> datetime.datetime:
    return datetime.datetime.now(datetime.timezone.utc)


def generate_key() -> ec.EllipticCurvePrivateKey:
    return ec.generate_private_key(ec.SECP256R1())


def key_to_pem(key) -> bytes:
    return key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption())


def key_from_pem(pem: bytes):
    return serialization.load_pem_private_key(pem, password=None)


def cert_to_pem(cert: x509.Certificate) -> bytes:
    return cert.public_bytes(serialization.Encoding.PEM)


def cert_from_pem(pem: bytes) -> x509.Certificate:
    return x509.load_pem_x509_certificate(pem)


def create_csr(node_id: str = "") -> tuple[bytes, bytes]:
    """Generate a key + CSR; returns (csr_pem, key_pem)
    (reference: GenerateNewCSR ca/certificates.go)."""
    key = generate_key()
    return (_csr_for_key(key, node_id), key_to_pem(key))


def create_csr_from_key(key_pem: bytes, node_id: str = "") -> bytes:
    """CSR over an EXISTING key — used for renewals, where the CSR's
    signature proves possession of the node's current key."""
    return _csr_for_key(key_from_pem(key_pem), node_id)


def _csr_for_key(key, node_id: str) -> bytes:
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME,
                                         node_id or "unknown")])
    csr = (x509.CertificateSigningRequestBuilder()
           .subject_name(name)
           .sign(key, hashes.SHA256()))
    return csr.public_bytes(serialization.Encoding.PEM)


@dataclass
class IssuedCertificate:
    cert_pem: bytes
    key_pem: Optional[bytes]   # None when signed from an external CSR
    # current CA trust bundle (old+new during a root rotation) — renewal
    # responses carry it so nodes refresh their trust store in step
    root_bundle: bytes = b""


class RootCA:
    """reference: ca.RootCA ca/certificates.go:170."""

    def __init__(self, cert_pem: bytes, key_pem: Optional[bytes] = None,
                 intermediates_pem: bytes = b"") -> None:
        self.cert_pem = cert_pem
        self.key_pem = key_pem
        self.intermediates_pem = intermediates_pem
        self.cert = cert_from_pem(cert_pem)
        self._key = key_from_pem(key_pem) if key_pem else None

    # ------------------------------------------------------------------
    @classmethod
    def create(cls, cn: str = "swarm-ca") -> "RootCA":
        """reference: CreateRootCA ca/certificates.go:771."""
        key = generate_key()
        name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, cn),
                          x509.NameAttribute(NameOID.ORGANIZATIONAL_UNIT_NAME,
                                             CA_ROLE_OU)])
        now = _now()
        cert = (x509.CertificateBuilder()
                .subject_name(name).issuer_name(name)
                .public_key(key.public_key())
                .serial_number(x509.random_serial_number())
                .not_valid_before(now - datetime.timedelta(minutes=5))
                .not_valid_after(now + datetime.timedelta(
                    seconds=ROOT_CA_EXPIRATION))
                .add_extension(x509.BasicConstraints(ca=True, path_length=None),
                               critical=True)
                # SKI/AKI disambiguate chain building: a rotation's old and
                # new roots share the same subject CN, and without key ids
                # OpenSSL may try the wrong same-subject issuer
                .add_extension(x509.SubjectKeyIdentifier.from_public_key(
                    key.public_key()), critical=False)
                .add_extension(x509.KeyUsage(
                    digital_signature=True, key_cert_sign=True,
                    crl_sign=True, content_commitment=False,
                    key_encipherment=False, data_encipherment=False,
                    key_agreement=False, encipher_only=False,
                    decipher_only=False), critical=True)
                .sign(key, hashes.SHA256()))
        return cls(cert_to_pem(cert), key_to_pem(key))

    @property
    def can_sign(self) -> bool:
        return self._key is not None

    def digest(self) -> str:
        """sha256 of the root cert DER — embedded in join tokens
        (reference: RootCA.Digest)."""
        der = self.cert.public_bytes(serialization.Encoding.DER)
        return hashlib.sha256(der).hexdigest()

    # ------------------------------------------------------------------
    def issue_node_certificate(self, node_id: str, role_ou: str, org: str,
                               csr_pem: Optional[bytes] = None,
                               expiry: float = DEFAULT_NODE_CERT_EXPIRATION
                               ) -> IssuedCertificate:
        """Sign a leaf for (node, role, org)
        (reference: IssueAndSaveNewCertificates :202 / signNodeCert)."""
        if not self.can_sign:
            raise CertificateError("this RootCA has no signing key")
        if role_ou not in (MANAGER_ROLE_OU, WORKER_ROLE_OU):
            raise CertificateError(f"invalid role OU {role_ou!r}")
        expiry = max(MIN_NODE_CERT_EXPIRATION, expiry)
        key_pem: Optional[bytes] = None
        if csr_pem is not None:
            csr = x509.load_pem_x509_csr(csr_pem)
            if not csr.is_signature_valid:
                raise CertificateError("CSR signature invalid")
            public_key = csr.public_key()
        else:
            key = generate_key()
            key_pem = key_to_pem(key)
            public_key = key.public_key()
        subject = x509.Name([
            x509.NameAttribute(NameOID.COMMON_NAME, node_id),
            x509.NameAttribute(NameOID.ORGANIZATIONAL_UNIT_NAME, role_ou),
            x509.NameAttribute(NameOID.ORGANIZATION_NAME, org)])
        now = _now()
        cert = (x509.CertificateBuilder()
                .subject_name(subject)
                .issuer_name(self.cert.subject)
                .public_key(public_key)
                .serial_number(x509.random_serial_number())
                .not_valid_before(now - datetime.timedelta(minutes=5))
                .not_valid_after(now + datetime.timedelta(seconds=expiry))
                .add_extension(x509.BasicConstraints(ca=False,
                                                     path_length=None),
                               critical=True)
                .add_extension(x509.SubjectKeyIdentifier.from_public_key(
                    public_key), critical=False)
                .add_extension(
                    x509.AuthorityKeyIdentifier.from_issuer_public_key(
                        self._key.public_key()), critical=False)
                .add_extension(x509.ExtendedKeyUsage(
                    [x509.oid.ExtendedKeyUsageOID.SERVER_AUTH,
                     x509.oid.ExtendedKeyUsageOID.CLIENT_AUTH]),
                    critical=False)
                .add_extension(x509.SubjectAlternativeName(
                    [x509.DNSName(TLS_SERVER_NAME), x509.DNSName(node_id)]),
                    critical=False)
                .sign(self._key, hashes.SHA256()))
        return IssuedCertificate(cert_pem=cert_to_pem(cert), key_pem=key_pem)

    # ------------------------------------------------------------------
    def validate_cert_chain(self, cert_pem: bytes) -> x509.Certificate:
        """Verify a leaf was signed by this root and is in its validity
        window (reference: CheckValidCertificate ca/config.go).  This
        RootCA's cert_pem may be an old+new BUNDLE mid-rotation — the leaf
        is accepted when it chains to ANY member root."""
        leaf = cert_from_pem(cert_pem)
        now = _now()
        if not (leaf.not_valid_before_utc <= now
                <= leaf.not_valid_after_utc):
            raise CertificateError("certificate outside validity window")
        try:
            roots = x509.load_pem_x509_certificates(self.cert_pem)
        except Exception:
            roots = [self.cert]
        last_err: Optional[Exception] = None
        for root in roots:
            try:
                root.public_key().verify(
                    leaf.signature, leaf.tbs_certificate_bytes,
                    ec.ECDSA(leaf.signature_hash_algorithm))
                return leaf
            except Exception as e:
                last_err = e
        raise CertificateError(
            f"certificate not signed by this CA: {last_err}")

    def cross_sign_ca_certificate(self, other_cert_pem: bytes) -> bytes:
        """Sign another root's public key with ours, for root rotation
        (reference: CrossSignCACertificate ca/certificates.go:410)."""
        if not self.can_sign:
            raise CertificateError("this RootCA has no signing key")
        other = cert_from_pem(other_cert_pem)
        now = _now()
        cert = (x509.CertificateBuilder()
                .subject_name(other.subject)
                .issuer_name(self.cert.subject)
                .public_key(other.public_key())
                .serial_number(x509.random_serial_number())
                .not_valid_before(now - datetime.timedelta(minutes=5))
                .not_valid_after(other.not_valid_after_utc)
                .add_extension(x509.BasicConstraints(ca=True,
                                                     path_length=None),
                               critical=True)
                .add_extension(x509.SubjectKeyIdentifier.from_public_key(
                    other.public_key()), critical=False)
                .add_extension(
                    x509.AuthorityKeyIdentifier.from_issuer_public_key(
                        self._key.public_key()), critical=False)
                .sign(self._key, hashes.SHA256()))
        return cert_to_pem(cert)


def parse_identity(cert_pem: bytes) -> tuple[str, str, str]:
    """(node_id, role_ou, org) from a leaf certificate
    (reference: ca/auth.go RemoteNode identity extraction)."""
    cert = cert_from_pem(cert_pem)

    def attr(oid):
        vals = cert.subject.get_attributes_for_oid(oid)
        return vals[0].value if vals else ""

    return (attr(NameOID.COMMON_NAME),
            attr(NameOID.ORGANIZATIONAL_UNIT_NAME),
            attr(NameOID.ORGANIZATION_NAME))


def is_issued_by(leaf_pem: bytes, root_cert_pem: bytes) -> bool:
    """True when the FIRST certificate in ``leaf_pem`` was signed by the
    root in ``root_cert_pem`` (rotation progress check — reference:
    ca/reconciler.go hasIssuer)."""
    try:
        leaf = cert_from_pem(leaf_pem)
        root = cert_from_pem(root_cert_pem)
        root.public_key().verify(
            leaf.signature, leaf.tbs_certificate_bytes,
            ec.ECDSA(leaf.signature_hash_algorithm))
        return True
    except Exception:
        return False


def split_bundle(bundle_pem: bytes) -> list[tuple[bytes, str]]:
    """(cert_pem, sha256-of-DER) for every certificate in a PEM bundle."""
    out = []
    try:
        for cert in x509.load_pem_x509_certificates(bundle_pem):
            der = cert.public_bytes(serialization.Encoding.DER)
            out.append((cert_to_pem(cert),
                        hashlib.sha256(der).hexdigest()))
    except Exception:
        pass
    return out


def bundle_digests(bundle_pem: bytes) -> list[str]:
    """sha256 digests of every certificate in a PEM bundle."""
    return [d for _, d in split_bundle(bundle_pem)]
