"""Step's device-to-host reads a tick over the window (kernel.COUNTS)."""


def read(ctx):
    ticks = ctx["window"]["ticks"]
    if not ticks or "host_syncs" not in ctx["counts"]:
        return None
    return ctx["counts"]["host_syncs"] / ticks
