"""What ``torch.profiler`` saw of the card during the traced window.

The profiler records the card's activity alone (kernels, copies, sets and
the CUDA runtime calls that start them), from just before the window's
first block to just after its closing synchronize, so every device event
in the trace is the window's.  Their union is ``busy_s``; ``window_s`` is
the window's wall on the host clock.  The gaps between busy intervals are
the idle time, each named by the device operation that ended it (what the
host went on to start after its own work: a copy up for the next stage, an
index program, a wave launch).  The profiler's own user annotations are
not device work and are left out.
"""

from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass, field


def _ns(ev, name):
    """An event's time in ns (torch releases name the accessors _ns or
    _us)."""
    f = getattr(ev, name + "_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(ev, name + "_us")() * 1000)


def short_name(name: str, width: int = 160) -> str:
    """A kernel's name without its return type and its argument list (the
    parenthesis that closes the name and the one that opens it), so that
    "(anonymous namespace)" inside the name stays."""
    name = re.sub(r"^void ", "", name)
    if name.endswith(")") and not name.startswith(("Memcpy", "Memset")):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i] or name
                break
    return name[:width]


@dataclass
class DeviceTrace:
    window_s: float
    busy_s: float
    ops: list = field(default_factory=list)     # [(name, seconds)] by time
    gaps: list = field(default_factory=list)    # [(name, seconds)] longest

    @property
    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)


def _is_device_work(ev) -> bool:
    if "cuda" not in str(ev.device_type()).lower():
        return False
    annot = getattr(ev, "is_user_annotation", None)
    if annot is not None and annot():
        return False
    kind = getattr(ev, "activity_type", None)
    return kind is None or "annotation" not in str(kind()).lower()


def reduce(events, window_s: float, top: int = 10) -> DeviceTrace | None:
    """A DeviceTrace of the window's kineto events, None when they hold no
    device work (the profiler recorded no device time)."""
    dev = sorted((_ns(ev, "start"), _ns(ev, "start") + _ns(ev, "duration"),
                  ev.name()) for ev in events if _is_device_work(ev))
    if not dev:
        return None
    per_op = defaultdict(int)
    busy = 0
    gaps = []
    end = dev[0][0]
    for a, b, n in dev:
        per_op[short_name(n)] += b - a
        if a > end:
            gaps.append((a - end, short_name(n)))
        busy += max(0, b - max(a, end))
        end = max(end, b)
    gaps.sort(key=lambda g: -g[0])
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:top]
    return DeviceTrace(
        window_s=window_s, busy_s=busy / 1e9,
        ops=[(n, t / 1e9) for n, t in ops],
        gaps=[(f"host work, then {n}", t / 1e9) for t, n in gaps[:top]])
