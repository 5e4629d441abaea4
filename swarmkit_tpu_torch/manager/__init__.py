"""Manager-side modules of the port: the Manager (manager.py) and every
service it starts: the control API, the orchestrators (replicated,
global, the task reaper, the constraint enforcer), the allocator, the
scheduler with its store loop and group placement, the dispatcher, the
log broker, the key and role managers, the watch and resource APIs,
health and the metrics collector."""
