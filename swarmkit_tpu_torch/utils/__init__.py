"""Small host utilities of the port."""

from swarmkit_tpu_torch.utils.identity import new_id
from swarmkit_tpu_torch.utils.clock import Clock, SystemClock, FakeClock

__all__ = ["new_id", "Clock", "SystemClock", "FakeClock"]
