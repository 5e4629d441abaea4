"""Raft consensus (PyTorch port): the batched tick simulation."""
