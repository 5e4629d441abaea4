"""Transport implementations behind the raft Transport seam.

Impl #1 (in-process asyncio wire) lives in swarmkit_tpu_torch.raft.transport,
impl #2 (cross-process gRPC) in swarmkit_tpu_torch.raft.grpc_transport, and
impl #3 (device mailbox exchange) here.
"""

from swarmkit_tpu_torch.transport.device_mesh import (  # noqa: F401
    DeviceMeshNet, DeviceMeshTransport,
)
