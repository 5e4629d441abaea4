"""Kernel time a tick over the profiled slice, in ms (the profiler's
device intervals, summed over the cards)."""


def read(ctx):
    sl = ctx["slice"]
    if not sl or not sl["ticks"] or not sl["kernels"]:
        return None
    return sum(e - s for _, s, e, _ in sl["kernels"]) / 1e3 / sl["ticks"]
