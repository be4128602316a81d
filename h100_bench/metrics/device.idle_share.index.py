"""device.idle_share.index: percent of the traced window (the traced
steps' spans) in which nothing ran on the card: 1 - the union of its
kernels, copies and fills over the window."""


def read(trace):
    w = trace.window_s()
    busy = trace.busy_s()
    if w <= 0 or busy <= 0:
        return None
    return 100.0 * (1.0 - busy / w)
