"""The worker side: the agent, its worker and session, the executor seam
and the task executor."""

from swarmkit_tpu_torch.agent.agent import Agent, AgentConfig
from swarmkit_tpu_torch.agent.exec import Controller, Executor, do_task_state
from swarmkit_tpu_torch.agent.worker import Worker

__all__ = ["Agent", "AgentConfig", "Controller", "Executor", "do_task_state",
           "Worker"]
