"""The share of an unprofiled tick in which no kernel or copy runs on
the card, in %: the profiled slice's device busy time a tick (the union
of its kernel and copy intervals, averaged over the cards) over the
CUDA-event wall a tick of its unprofiled twin, the unit of the same mix
timed just before it (the profiler stretches the host's gaps, so the
slice's own wall would overstate idle time; profile_tick.py's busy
share)."""

from benchmark.trace import busy_s


def read(ctx):
    sl = ctx["slice"]
    if not sl or not sl["kernels"] or not sl.get("twin_ticks") \
            or not sl["ticks"]:
        return None
    busy_tick = busy_s(sl) / sl["ticks"]
    wall_tick = sl["twin_wall_s"] / sl["twin_ticks"]
    return 100.0 * (1.0 - busy_tick / wall_tick)
