"""device_idle_pct (%, per layer): the share of the traced window (the
first job's start to the last job's end) in which no kernel, copy or fill
ran on the device, from the profiler's timeline. Nothing to read where
the trace holds no device activity (a run off the card)."""


def read(ctx):
    tl = ctx["timeline"]
    if tl is None or tl.window_s <= 0 or tl.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tl.busy_s / tl.window_s)
