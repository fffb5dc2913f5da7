"""Device busy and idle time from a timeline of device operations.

Operations on several streams overlap, so busy time is the length of the
union of their intervals, not the sum of their durations (a sum counts an
overlap twice and can pass the window's length)."""

from __future__ import annotations


def merge(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The union of [start, end) intervals clipped to [lo, hi], as sorted
    disjoint intervals."""
    out: list[list[float]] = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy(intervals, lo: float, hi: float) -> float:
    """Length of [lo, hi] that some interval covers."""
    return sum(e - s for s, e in merge(intervals, lo, hi))


def idle_share(intervals, lo: float, hi: float) -> float:
    """Share of [lo, hi] that no interval covers, in [0, 1]."""
    if hi <= lo:
        raise ValueError("empty window")
    return 1.0 - busy(intervals, lo, hi) / (hi - lo)


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The idle stretches of [lo, hi] between the merged intervals."""
    out, t = [], lo
    for s, e in merge(intervals, lo, hi):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out
