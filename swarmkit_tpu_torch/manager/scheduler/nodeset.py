"""Node set with spread-preference decision tree and least-loaded selection.

Reference: manager/scheduler/nodeset.go (nodeSet, findBestNodes),
decision_tree.go (preference tree), nodeheap.go (max-heap of the best K by
fewest active tasks for the relevant service).

The port's own copy of the JAX package's module of the same name, with the
same dict insertion order: the order in which nodes were inserted is the
tie-break of last resort.
"""

from __future__ import annotations

from typing import Callable, Optional

from swarmkit_tpu_torch.manager.scheduler.nodeinfo import NodeInfo


class DecisionTree:
    """reference: decision_tree.go — buckets nodes by each spread preference
    level, then picks from buckets round-robin so replicas spread evenly."""

    def __init__(self) -> None:
        self.next_level: Optional[dict[str, "DecisionTree"]] = None
        self.nodes: list[NodeInfo] = []

    def insert(self, keys: list[str], info: NodeInfo) -> None:
        self.nodes.append(info)
        if not keys:
            return
        if self.next_level is None:
            self.next_level = {}
        child = self.next_level.setdefault(keys[0], DecisionTree())
        child.insert(keys[1:], info)

    def order_best(self, n: int, better: Callable[[NodeInfo, NodeInfo], bool],
                   load: Callable[[NodeInfo], int]) -> list[NodeInfo]:
        """Pick up to n nodes, preferring the least-loaded branch first
        (reference: decision_tree.go orderedNodes weighs subtrees by their
        task count for the service, so replicas spread across branches)."""
        if not self.next_level:
            return _best_k(self.nodes, n, better)
        ranked = sorted(
            ((sum(load(i) for i in child.nodes),
              child.order_best(n, better, load))
             for child in self.next_level.values()),
            key=lambda pair: pair[0])
        branches = [b for _, b in ranked]
        out: list[NodeInfo] = []
        # round-robin across branches, least-loaded first
        idx = 0
        while len(out) < n:
            progressed = False
            for b in branches:
                if idx < len(b):
                    out.append(b[idx])
                    progressed = True
                    if len(out) >= n:
                        break
            if not progressed:
                break
            idx += 1
        return out


def _best_k(nodes: list[NodeInfo], k: int,
            better: Callable[[NodeInfo, NodeInfo], bool]) -> list[NodeInfo]:
    """Top-k by the comparison function (reference: nodeheap.go)."""
    import functools

    def cmp(a: NodeInfo, b: NodeInfo) -> int:
        if better(a, b):
            return -1
        if better(b, a):
            return 1
        return 0

    return sorted(nodes, key=functools.cmp_to_key(cmp))[:k]


def spread_keys(preferences: list[str], info: NodeInfo) -> list[str]:
    """Bucket keys for each `spread=node.labels.X` preference
    (reference: nodeset.go tree)."""
    keys = []
    for pref in preferences:
        if "=" in pref:
            strategy, descriptor = pref.split("=", 1)
        else:
            strategy, descriptor = "spread", pref
        if strategy.strip().lower() != "spread":
            continue
        descriptor = descriptor.strip()
        if descriptor.startswith("node.labels."):
            label = descriptor[len("node.labels."):]
            keys.append(info.node.spec.annotations.labels.get(label, ""))
        elif descriptor == "node.id":
            keys.append(info.node.id)
        else:
            keys.append("")
    return keys


class NodeSet:
    """reference: nodeSet nodeset.go:50."""

    def __init__(self) -> None:
        self.nodes: dict[str, NodeInfo] = {}

    def add_or_update(self, info: NodeInfo) -> None:
        self.nodes[info.id] = info

    def remove(self, node_id: str) -> None:
        self.nodes.pop(node_id, None)

    def get(self, node_id: str) -> Optional[NodeInfo]:
        return self.nodes.get(node_id)

    def find_best_nodes(self, n: int, meets: Callable[[NodeInfo], bool],
                        preferences: list[str],
                        better: Callable[[NodeInfo, NodeInfo], bool],
                        load: Optional[Callable[[NodeInfo], int]] = None
                        ) -> list[NodeInfo]:
        """reference: findBestNodes nodeset.go."""
        tree = DecisionTree()
        for info in self.nodes.values():
            if meets(info):
                tree.insert(spread_keys(preferences, info), info)
        return tree.order_best(n, better,
                               load or (lambda i: i.active_task_count()))
