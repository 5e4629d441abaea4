"""The event bus (the port's own copy of the JAX package's watch/)."""

from swarmkit_tpu_torch.watch.queue import Queue, Watcher, WatcherClosed

__all__ = ["Queue", "Watcher", "WatcherClosed"]
