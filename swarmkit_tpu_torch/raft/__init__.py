"""Raft consensus (PyTorch port): the batched tick simulation (sim/), and
the host consensus member: the node shell (node.py) over the golden core
(core.py, rawnode.py) with its WAL (storage.py), membership and wire."""
