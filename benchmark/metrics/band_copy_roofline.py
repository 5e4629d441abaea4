"""append_band_copy's share of its byte bound over the profiled slice:
the bytes its calls had to move (kernel_bytes.band_bytes from each
call's own mask) at the card's HBM rate, over the time of its kernels
(csrc/band_copy.cu's band_copy_* by name), in %.  Bytes counted too high,
or a time that leaves out part of the work, reads above 100: nothing
here caps it."""

from benchmark.kernel_bytes import band_bytes


def kernel_seconds(sl) -> float:
    return sum(e - s for name, s, e, _ in sl["kernels"]
               if "band_copy_" in name and "empty" not in name) / 1e6


def read(ctx):
    sl, peaks = ctx["slice"], ctx["peaks"]
    if not sl or not peaks:
        return None
    calls = sl["calls"].get("append_band_copy", [])
    # the mask is the call's last argument: ("mask", elements, written)
    moved = sum(band_bytes(a[-1][1], a[-1][2]) for a in calls)
    secs = kernel_seconds(sl)
    if not calls or secs <= 0:
        return None
    return 100.0 * moved / peaks["hbm_bytes_per_s"] / secs
