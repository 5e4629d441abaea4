"""The API objects of the port (its own copy of the JAX package's api/)."""

from swarmkit_tpu_torch.api.types import (
    TaskState, NodeRole, NodeState, NodeAvailability, Meta, Version,
    Annotations, TaskStatus, NodeDescription, NodeResources, Platform,
    EngineDescription, Endpoint, EndpointVIP, PortConfig, NetworkAttachment,
    Driver, Peer, WeightedPeer, IPAMConfig, IPAMOptions, MembershipState,
    TERMINAL_STATES,
)
from swarmkit_tpu_torch.api.serde import Message
from swarmkit_tpu_torch.api.specs import (
    NodeSpec, ServiceSpec, TaskSpec, ClusterSpec, NetworkSpec, SecretSpec,
    ConfigSpec, RaftConfig, CAConfig, DispatcherConfig, TaskDefaults,
    EndpointSpec, Mode, RestartPolicy, UpdateConfig, Placement,
    ContainerSpec, Resources, ResourceRequirements, ReplicatedService,
    GlobalService, RestartCondition, UpdateFailureAction, UpdateOrder,
    OrchestrationConfig, EncryptionConfig, SecretReference, ConfigReference,
)
from swarmkit_tpu_torch.api.objects import (
    Node, NodeStatus, Service, Task, Network, Cluster, Secret, Config,
    Resource, Extension, OBJECT_KINDS, kind_of,
)
from swarmkit_tpu_torch.api.raft_msgs import (
    StoreAction, StoreActionKind, InternalRaftRequest, Snapshot,
    StoreSnapshot, ClusterMember, ClusterSnapshot,
)
