"""Host ms a tick of the window's failovers: their summed seconds over
their summed ticks (the traced run profiles only after the window, so
none of them runs in the profiler's wake)."""


def read(ctx):
    fo = ctx["failovers"]
    if not fo:
        return None
    return 1e3 * sum(s for s, _ in fo) / sum(t for _, t in fo)
