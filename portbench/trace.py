"""The reduction of a ``torch.profiler`` capture to what the per-layer
readers and the result's ``breakdown`` need.

The capture covers the traced run's profiled sub-window, which the
harness brackets with a ``portbench:window`` range and each unit of work
with ``portbench:unit``.  Device activity is every event the profiler
places on the card (kernels, copies, sets).  The device is busy where
the union of their intervals lies, so overlapping work counts once; the
idle share is what the union leaves of the window.  An idle gap is named
by what the host was doing at its midpoint: the innermost ``csvplus:``
stage or ``portbench:`` range open then, and the innermost host
operation inside it.
"""

from __future__ import annotations

import bisect
from collections import Counter, defaultdict

WINDOW = "portbench:window"
UNIT = "portbench:unit"


_RANGES = ("csvplus:", "portbench:")


def _on_card(ev) -> bool:
    return "cuda" in str(ev.device_type()).lower()


def _mirror(ev) -> bool:
    """The profiler's copy of a host range on the card's timeline: no
    device work, and no host range either."""
    return getattr(ev, "is_user_annotation", lambda: False)() or ev.name().startswith(_RANGES)


class DeviceTrace:
    """Device intervals, kernel names and host ranges of one capture."""

    def __init__(self, prof):
        events = prof.profiler.kineto_results.events()
        self.device = []  # (start_ns, end_ns, name)
        host = []  # (start_ns, end_ns, name)
        for ev in events:
            start = int(ev.start_ns())
            end = start + int(ev.duration_ns())
            if not _on_card(ev):
                host.append((start, end, ev.name()))
            elif not _mirror(ev):
                self.device.append((start, end, ev.name()))
        windows = [(s, e) for s, e, n in host if n == WINDOW]
        if not windows:
            raise RuntimeError("the capture holds no portbench:window range")
        self.t0, self.t1 = windows[0]
        self.units = sorted((s, e) for s, e, n in host if n == UNIT)
        inside = [(s, e, n) for s, e, n in host if s < self.t1 and e > self.t0]
        self.ranges = sorted(x for x in inside if x[2].startswith(_RANGES) and x[2] != WINDOW)
        self.ops = sorted(x for x in inside if not x[2].startswith(_RANGES))
        self.launches = sorted(s for s, e, n in inside if "LaunchKernel" in n)
        self.device = sorted(x for x in self.device if x[0] < self.t1 and x[1] > self.t0)
        self._busy = self._union()

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def _union(self) -> list:
        """Merged device intervals, clipped to the window."""
        out = []
        for s, e, _ in self.device:
            s, e = max(s, self.t0), min(e, self.t1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self._busy) / 1e9

    def idle_pct(self) -> "float | None":
        if not self.device:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def kernel_seconds(self, fragment: str) -> "tuple[float, int]":
        """Summed device seconds and count of the kernels whose name
        holds *fragment*."""
        hits = [(e - s) for s, e, n in self.device if fragment in n]
        return sum(hits) / 1e9, len(hits)

    def kernel_count(self) -> int:
        """Kernels run on the card in the window (copies and sets left
        out)."""
        return sum(1 for _, _, n in self.device if not n.startswith(("Memcpy", "Memset")))

    def launches_per_unit(self) -> list:
        """Kernel launches the host made inside each unit's range."""
        counts = []
        for s, e in self.units:
            counts.append(bisect.bisect_left(self.launches, e)
                          - bisect.bisect_left(self.launches, s))
        return counts

    def top_device_ops(self, k: int = 10) -> list:
        by = defaultdict(int)
        for s, e, n in self.device:
            by[_short(n)] += e - s
        return [[n, t / 1e9] for n, t in sorted(by.items(), key=lambda x: -x[1])[:k]]

    def _innermost(self, items: list, t: int) -> "str | None":
        """The latest-starting interval of *items* (sorted by start) that
        holds *t*: on one thread, the innermost."""
        i = bisect.bisect_right(items, (t, float("inf"), "")) - 1
        for j in range(i, max(-1, i - 4000), -1):
            s, e, n = items[j]
            if s <= t <= e:
                return n
        return None

    def idle_gaps(self, k: int = 10) -> list:
        """Idle device time summed by what the host was doing, largest
        first."""
        edges = [self.t0] + [x for iv in self._busy for x in iv] + [self.t1]
        by = Counter()
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) // 2
            where = self._innermost(self.ranges, mid) or "portbench:window"
            op = self._innermost(self.ops, mid)
            by[f"{where} / {_short(op)}" if op else where] += b - a
        return [[n, t / 1e9] for n, t in by.most_common(k)]


def _short(name: str, width: int = 120) -> str:
    """A kernel or operation name without its argument list."""
    name = name.replace("(anonymous namespace)", "anon")
    name = name[5:] if name.startswith("void ") else name
    return name.split("(")[0].strip()[:width]
