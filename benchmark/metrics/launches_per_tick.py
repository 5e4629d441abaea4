"""Device kernels a tick over the profiled slice."""


def read(ctx):
    sl = ctx["slice"]
    if not sl or not sl["ticks"] or not sl["kernels"]:
        return None
    return len(sl["kernels"]) / sl["ticks"]
