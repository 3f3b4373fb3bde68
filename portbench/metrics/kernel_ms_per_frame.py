"""Device time of the port's hand kernels per frame, in ms/frame: their
traced time over the common stretch, summed over the sessions, divided by
the frames the window's rate gives that stretch."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not ctx["rate"]:
        return None
    kernel_of = ctx["kernel_of"]
    sec = sum(e - s for n, s, e in tr["device_ops"] if kernel_of(n))
    a, b = tr["stretch"]
    if not sec:
        return None
    return 1e3 * sec / ((b - a) * ctx["rate"])
