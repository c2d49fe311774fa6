"""mash_shared_roofline (%, per layer): the Mash kernel's
(csrc/mash_shared.cu) share of its roofline over the traced window. The
least time the chip could take for the window's dense jobs (each: the
merge steps of every pair it decides at 67 T/s, or its bytes at
3.35 TB/s, whichever is longer; benchmark/roofline/mash.py) over the
device time of the kernels whose name holds ``mash_shared`` in the
profiler's trace. Nothing to read without a dense job or without such a
kernel in the trace."""


def read(ctx):
    tl, bounds = ctx["timeline"], ctx["kernel_bounds"]
    if tl is None or "mash_shared" not in bounds:
        return None
    kernel_s = tl.device_seconds("mash_shared")
    if kernel_s <= 0:
        return None
    return 100.0 * bounds["mash_shared"] * len(ctx["records"]) / kernel_s
