from swarmkit_tpu_torch.node.node import Node, NodeConfig
from swarmkit_tpu_torch.node.remotes import Remotes

__all__ = ["Node", "NodeConfig", "Remotes"]
