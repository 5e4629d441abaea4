"""Manager-side modules of the port: the log broker types the agent
needs, placement constraints and the scheduler's group placement."""
