"""Mean ticks from a leader's crash to the first tick at which the
cluster's commit passes its pre-crash value (from the run loop's trace
rows; a protocol count)."""


def read(ctx):
    fo = ctx["failovers"]
    if not fo:
        return None
    return sum(t for _, t in fo) / len(fo)
