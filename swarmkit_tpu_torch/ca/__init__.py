from swarmkit_tpu_torch.ca.auth import (
    PermissionDenied, RemoteNodeInfo, authorize_org_and_role,
)
from swarmkit_tpu_torch.ca.certificates import (
    CA_ROLE_OU, DEFAULT_NODE_CERT_EXPIRATION, MANAGER_ROLE_OU,
    WORKER_ROLE_OU, CertificateError, IssuedCertificate, RootCA, create_csr, create_csr_from_key,
    parse_identity,
)
from swarmkit_tpu_torch.ca.config import (
    InvalidJoinToken, SecurityConfig, TLSRenewer, generate_join_token,
    parse_join_token,
)
from swarmkit_tpu_torch.ca.keyreadwriter import KeyReadWriter
from swarmkit_tpu_torch.ca.server import CAServer

__all__ = [
    "CA_ROLE_OU", "MANAGER_ROLE_OU", "WORKER_ROLE_OU",
    "DEFAULT_NODE_CERT_EXPIRATION", "CertificateError", "IssuedCertificate",
    "RootCA", "create_csr", "create_csr_from_key", "parse_identity", "InvalidJoinToken",
    "SecurityConfig", "TLSRenewer", "generate_join_token",
    "parse_join_token", "KeyReadWriter", "CAServer", "PermissionDenied",
    "RemoteNodeInfo", "authorize_org_and_role",
]
