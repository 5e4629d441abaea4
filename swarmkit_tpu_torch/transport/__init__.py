"""Transport implementations behind the raft Transport seam.

Impl #1 (in-process asyncio wire) lives in swarmkit_tpu_torch.raft.transport;
impl #3 (device mailbox exchange) here.  The JAX package's impl #2
(cross-process gRPC) is a host-only layer and is not ported.
"""

from swarmkit_tpu_torch.transport.device_mesh import (  # noqa: F401
    DeviceMeshNet, DeviceMeshTransport,
)
