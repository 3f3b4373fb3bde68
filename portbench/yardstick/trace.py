"""Reading a traced stretch: device operations and host scopes out of the
profiler's events, and the busy and idle arithmetic over them.

`device_intervals` keeps tools/profile_decode.py:_split's rule at commit
6cd77e7 (the device-side events other than the theora.* annotation
ranges, each lasting its time_range), but keeps each operation's start
and end instead of summing them, so that the busy time of several
processes sharing one card can be merged (`merge`, `busy_seconds`) and
its idle gaps found (`gaps`).
"""
from __future__ import annotations


def device_intervals(events, offset: float) -> list:
    """[name, start, end] of every device operation (kernels, copies,
    fills), in seconds on the host's monotonic clock: offset is the clock
    at the profiler's zero."""
    from torch.autograd import DeviceType

    return [[e.name, offset + e.time_range.start / 1e6,
             offset + e.time_range.end / 1e6]
            for e in events
            if e.device_type != DeviceType.CPU
            and not e.name.startswith("theora.")]


def host_scopes(events, offset: float) -> list:
    """[name, start, end] of the program's theora.* record_function
    ranges on the host, on the same clock."""
    from torch.autograd import DeviceType

    return [[e.name, offset + e.time_range.start / 1e6,
             offset + e.time_range.end / 1e6]
            for e in events
            if e.device_type == DeviceType.CPU
            and e.name.startswith("theora.")]


def clip(intervals, a: float, b: float) -> list:
    """The parts of [name, start, end] intervals inside [a, b]."""
    return [[n, max(s, a), min(e, b)] for n, s, e in intervals
            if e > a and s < b]


def merge(intervals) -> list:
    """The union of [name, start, end] intervals as sorted (start, end)."""
    out = []
    for s, e in sorted((s, e) for _, s, e in intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_seconds(intervals) -> float:
    return sum(e - s for s, e in merge(intervals))


def gaps(intervals, a: float, b: float) -> list:
    """(start, end) of the stretches of [a, b] that no interval covers."""
    out, t = [], a
    for s, e in merge(clip(intervals, a, b)):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if t < b:
        out.append((t, b))
    return out


def innermost(scopes, t: float) -> str | None:
    """The name of the shortest scope that holds time t."""
    best = None
    for n, s, e in scopes:
        if s <= t <= e and (best is None or e - s < best[1]):
            best = (n, e - s)
    return None if best is None else best[0]
