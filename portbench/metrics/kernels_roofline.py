"""The hand kernels' share of their roofline over the traced stretch, in
%: the sum of each launch's bound (the yardstick's bounds.py at the
cell's own arguments, recorded per call over one whole job after the
window and spread evenly over that kernel's launches) over the sum of the
same launches' traced time. Kernels whose bound was not recorded are left
out of both sums."""


def read(ctx):
    tr, bounds = ctx["trace"], ctx["bounds"]
    if tr is None or not bounds:
        return None
    from yardstick.kernels import KERNELS

    kernel_of = ctx["kernel_of"]
    launches, secs = {}, {}
    for n, s, e in tr["device_ops"]:
        k = kernel_of(n)
        if k in bounds:
            launches[k] = launches.get(k, 0) + 1
            secs[k] = secs.get(k, 0.0) + (e - s)
    total = sum(secs.values())
    if not total:
        return None
    bound = sum(launches[k] / len(KERNELS[k][2])
                * bounds[k][0] / bounds[k][1] for k in launches)
    return 100.0 * bound / total
