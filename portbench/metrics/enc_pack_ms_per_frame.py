"""Host packing per encoded frame: GopEncoder.host_pack_s summed over the
sessions' window, in ms/frame."""


def read(ctx):
    s = ctx["counters"].get("host_pack_s")
    if s is None or not ctx["frames"]:
        return None
    return 1e3 * s / ctx["frames"]
