"""Host parse per decoded frame: BatchDecoder.host_parse_s summed over the
sessions' window, in ms/frame."""


def read(ctx):
    s = ctx["counters"].get("host_parse_s")
    if s is None or not ctx["frames"]:
        return None
    return 1e3 * s / ctx["frames"]
