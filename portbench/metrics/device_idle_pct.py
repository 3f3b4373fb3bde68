"""The card's idle share of the common traced stretch, in %: 1 minus the
union of every session's device operations (kernels, copies, fills)
inside the stretch over its length."""

from yardstick import trace


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    a, b = tr["stretch"]
    return 100.0 * (1.0 - trace.busy_seconds(tr["device_ops"]) / (b - a))
