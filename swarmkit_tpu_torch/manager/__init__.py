"""Manager-side modules of the port: the control API, the replicated
orchestrator, the scheduler with its store loop and group placement, the
dispatcher, placement constraints and the log broker types the agent
needs."""
