"""Device time of the read path (the tick's phase ranges phase_R0..R2)
a tick over the profiled slice, in ms."""


def read(ctx):
    sl = ctx["slice"]
    if not sl or not sl["ticks"]:
        return None
    us = [v for k, v in sl["phases"].items() if k.startswith("phase_R")]
    if not us:
        return None
    return sum(us) / 1e3 / sl["ticks"]
