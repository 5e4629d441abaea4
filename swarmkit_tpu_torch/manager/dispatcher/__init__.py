from swarmkit_tpu_torch.manager.dispatcher.dispatcher import (
    Dispatcher, DispatcherConfigDefaults, ErrNodeNotRegistered,
    ErrSessionInvalid, ErrNodeNotFound,
)

__all__ = [
    "Dispatcher", "DispatcherConfigDefaults", "ErrNodeNotRegistered",
    "ErrSessionInvalid", "ErrNodeNotFound",
]
