"""The device timeline of a profiled stretch: the device operations
(kernels, copies, fills) of ``torch.profiler``'s CUDA activity, and the
benchmark's host spans, taken on the host with ``time.time_ns`` (the clock
of the profiler's Unix-time stamps), so the profiler records no host op
of the loop.

The stretch starts after a synchronize and ends after one, so every device
operation it launched lies inside it.
"""

import re

from torch.autograd import DeviceType

HOST_SPANS = ("get_batch", "to_device", "prepare_batch", "train_step",
              "read_losses")


def device_events(prof):
    """(start ns, end ns, name) of every device operation of a profile."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        if hasattr(e, "is_user_annotation") and e.is_user_annotation():
            continue
        start = e.start_ns()
        out.append((start, start + e.duration_ns(), e.name()))
    return out


def short_name(name):
    """A device operation's name without its return type, parameters,
    ``at::native::`` and anonymous namespaces, and template arguments
    nested below the first level."""
    name = re.sub(r"^void ", "", name.replace("(anonymous namespace)::", ""))
    name = name.replace("at::native::", "")
    out, depth = [], 0
    for ch in name:
        if ch == "(" and depth == 0 and out:
            break
        if ch == "<":
            depth += 1
            if depth == 1:
                out.append(ch)
        elif ch == ">":
            if depth == 1:
                out.append(ch)
            depth -= 1
        elif depth <= 1:
            out.append(ch)
    return re.sub(r"\s+", " ", "".join(out)).strip()[:120]


class Timeline:
    """Device intervals and host spans of one profiled stretch
    [``start``, ``end``] (ns)."""

    def __init__(self, events, start, end, host):
        self.start, self.end = start, end
        self.device = sorted((max(s, start), min(e, end), n)
                             for s, e, n in events if e > start and s < end)
        self.outside = len(events) - len(self.device)
        self.host = sorted(host)

    @property
    def window_s(self):
        return (self.end - self.start) * 1e-9

    def busy_intervals(self):
        """The union of the device intervals, as sorted (start, end)."""
        merged = []
        for s, e, _ in self.device:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self):
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def device_s(self, patterns):
        """Seconds of the device operations whose name holds one of
        ``patterns``."""
        return sum(e - s for s, e, n in self.device
                   if any(p in n for p in patterns)) * 1e-9

    def device_ops(self):
        """{short name: seconds} of every device operation."""
        out = {}
        for s, e, n in self.device:
            k = short_name(n)
            out[k] = out.get(k, 0.0) + (e - s) * 1e-9
        return out

    def idle_gaps(self):
        """{host span: seconds} of the device's idle time, each gap put
        under the innermost benchmark span open on the host at its start
        (``outside_spans`` when none is)."""
        out = {}
        t = self.start
        gaps = []
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.end > t:
            gaps.append((t, self.end))
        for g0, g1 in gaps:
            label = "outside_spans"
            best = None
            for s, e, n in self.host:
                if s > g0:
                    break
                if e >= g0 and (best is None or s >= best):
                    best, label = s, n
            out[label] = out.get(label, 0.0) + (g1 - g0) * 1e-9
        return out
