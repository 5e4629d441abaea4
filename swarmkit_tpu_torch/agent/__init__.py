"""The worker side: the executor seam and the task executor."""
