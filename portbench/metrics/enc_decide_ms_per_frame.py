"""Host mode decision and adaptive-quant gates per encoded frame:
GopEncoder.host_decide_s summed over the sessions' window, in ms/frame."""


def read(ctx):
    s = ctx["counters"].get("host_decide_s")
    if s is None or not ctx["frames"]:
        return None
    return 1e3 * s / ctx["frames"]
