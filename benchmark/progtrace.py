"""The program's spans and counters (``stylemesh_tpu_torch.utils.profiling``)
joined to the device trace, for the metrics that read a layer inside the
program (``enqueue_ms``, ``forward_ms``, ``backward_ms``, ``update_ms``,
``h2d_gbps``).

The first of those readers runs the *recorded stretches*, after the
traced window, each of :data:`RECORDED_CHUNKS` whole chunks of the same
loop with the program's recorder on: first one without the profiler,
whose ``train_step`` spans give the host's time to queue a step
(``enqueue_ms``), then one under ``torch.profiler`` (CUDA activity only)
with the harness's spans marked. In the second, each device operation is
linked by its correlation id to the CUDA API call that launched it, and
is given to the innermost program span open on the host at that call's
time: by time, not by thread, since autograd launches the backward from
its own thread while the step's thread waits inside ``backward``. The
readers of a run share the stretches. On a program without the recorder,
or off CUDA, they read nothing.
"""

import bisect
import dataclasses
import json
import statistics
import time

import torch
from torch.autograd import DeviceType

from benchmark import devtrace, harness

RECORDED_CHUNKS = 3  # whole chunks in each recorded stretch
PAD_S = 0.05  # the profile's margin on each side of the stretch
LAUNCH_KINDS = ("cuda_runtime", "cuda_driver")
H2D = ("HtoD",)  # in the names of host-to-device copies
OUTSIDE = "outside_spans"
UNLINKED = "unlinked"  # device operations with no launch record
# the CUDA API calls that launch a kernel, copy or fill
LAUNCHING = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cuMemcpy",
             "cudaMemset", "cuMemset")


def launch_trace(prof):
    """(device operations as (start ns, end ns, name, correlation id),
    {correlation id: host ns of the launching call}, the correlation ids of
    the calls that launch device work) of a profile of CUDA activity alone,
    whose host-side events are the CUDA API calls (by their kind, where the
    events name it)."""
    ops, launches, expected = [], {}, set()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if hasattr(e, "is_user_annotation") and e.is_user_annotation():
                continue
            start = e.start_ns()
            ops.append((start, start + e.duration_ns(), e.name(),
                        e.correlation_id()))
        elif e.correlation_id() and (not hasattr(e, "activity_type")
                                     or e.activity_type() in LAUNCH_KINDS):
            t = launches.get(e.correlation_id())
            if t is None or e.start_ns() < t:
                launches[e.correlation_id()] = e.start_ns()
            if e.name().startswith(LAUNCHING):
                expected.add(e.correlation_id())
    return ops, launches, expected


def host_s(spans, name):
    """Host seconds of each of ``spans`` (``profiling.Span``) called
    ``name``, in order."""
    return [(s.end_ns - s.start_ns) * 1e-9 for s in spans if s.name == name]


class Innermost:
    """The innermost of nested host intervals ``(start, end, key)`` open at
    a time: a sorted list of boundaries, each with the key that holds until
    the next."""

    def __init__(self, intervals):
        bounds = []
        for i, (s, e, _) in enumerate(intervals):
            bounds.append((s, 1, -e, i))  # opens: the outer one first
            bounds.append((e, 0, -s, i))  # closes before opens; inner first
        bounds.sort()
        self.times, self.keys = [], []
        stack = []
        for t, opens, _, i in bounds:
            if opens:
                stack.append(i)
            else:
                stack.remove(i)
            key = intervals[stack[-1]][2] if stack else None
            if self.times and self.times[-1] == t:
                self.keys[-1] = key
            else:
                self.times.append(t)
                self.keys.append(key)

    def at(self, t):
        j = bisect.bisect_right(self.times, t) - 1
        return self.keys[j] if j >= 0 else None


class Join:
    """Device operations of a stretch [``start``, ``end``] (ns) given to
    the program's ``spans`` (``profiling.Span``) by launch time; ``marks``
    are the harness's spans (start, end, name) of the same stretch."""

    def __init__(self, ops, launches, spans, marks, start, end, steps,
                 counters=None, expected=()):
        self.spans, self.marks = list(spans), list(marks)
        self.steps = steps
        self.counters = dict(counters or {})
        # the stretch's launching calls whose device operation the profile
        # lacks
        self.missing = {c for c in set(expected) - {c for *_, c in ops}
                        if start <= launches[c] <= end}
        # the stretch's device operations: those launched in it, and those
        # with no launch record that ran in it (the device's converted
        # clock can put the last ones a fraction of a millisecond after
        # ``end``, so the launch decides)
        ops = [op for op in ops
               if (start <= launches[op[3]] <= end if op[3] in launches
                   else op[1] > start and op[0] < end)]
        end = max([end] + [e for _, e, _, _ in ops])
        self.timeline = devtrace.Timeline(
            [(s, e, n) for s, e, n, _ in ops], start, end, [])
        # the host spans that label an idle gap: the union of the
        # harness's and the program's
        self._host = Innermost(self.marks + [(s.start_ns, s.end_ns, s.name)
                                             for s in self.spans])
        inner = Innermost([(s.start_ns, s.end_ns, i)
                           for i, s in enumerate(self.spans)])
        # every op: (seconds, name, innermost span index, or OUTSIDE /
        # UNLINKED)
        self.ops = []
        for s, e, n, c in ops:
            t = launches.get(c)
            where = UNLINKED if t is None else inner.at(t)
            self.ops.append(((e - s) * 1e-9, n,
                             OUTSIDE if where is None else where))
        self._names = []  # the names of each span and its ancestors
        for s in self.spans:
            names = {s.name}
            if s.parent is not None:
                names |= self._names[s.parent]
            self._names.append(names)

    def _inside(self, name, patterns=()):
        for sec, op, where in self.ops:
            inside = (where == name if isinstance(where, str)
                      else name in self._names[where])
            if inside and (not patterns or any(p in op for p in patterns)):
                yield sec

    def device_s(self, name, patterns=()):
        """Seconds of the device operations launched inside a span called
        ``name`` (``OUTSIDE``: outside every span; ``UNLINKED``: with no
        launch record), those whose name holds one of ``patterns`` alone if
        given."""
        return sum(self._inside(name, patterns))

    def launches(self, name):
        """Device operations launched inside a span called ``name``."""
        return sum(1 for _ in self._inside(name))

    def host_s(self, name):
        """Host seconds of each span called ``name``, in order."""
        return host_s(self.spans, name)

    def self_s(self, name):
        """Host seconds of the spans called ``name`` that none of their
        children covers."""
        total = sum(self.host_s(name))
        for s in self.spans:
            if s.parent is not None and self.spans[s.parent].name == name:
                total -= (s.end_ns - s.start_ns) * 1e-9
        return total

    def rows(self):
        """[name, host ms, host self ms, device ms, launches], each a step,
        for every span name in the order first opened, then
        ``outside_spans`` and, if any, ``unlinked``."""
        per = 1.0 / max(self.steps, 1)
        names = list(dict.fromkeys(s.name for s in self.spans))
        out = [[n, sum(self.host_s(n)) * per * 1e3,
                self.self_s(n) * per * 1e3, self.device_s(n) * per * 1e3,
                self.launches(n) * per] for n in names]
        for n in (OUTSIDE, UNLINKED):
            if n == OUTSIDE or self.launches(n):
                out.append([n, 0.0, 0.0, self.device_s(n) * per * 1e3,
                            self.launches(n) * per])
        return out

    def idle_gaps(self):
        """[label, seconds a step] of the device's idle time, each gap under
        the innermost span open at its start of the union of the
        harness's and the program's spans, largest first."""
        per = 1.0 / max(self.steps, 1)
        out = {}
        t = self.timeline.start
        end = self.timeline.end
        for s, e in self.timeline.busy_intervals() + [[end, end]]:
            if s > t:
                label = self._host.at(t) or OUTSIDE
                out[label] = out.get(label, 0.0) + (s - t) * 1e-9 * per
            t = max(t, e)
        return sorted(([k, v] for k, v in out.items()), key=lambda kv: -kv[1])


@dataclasses.dataclass
class RecordedStretch(harness.Stretch):
    """A recorded stretch: its ``program`` (``profiling.Recording``) and,
    for the profiled one, its ``join`` to the device trace."""

    program: object = None
    join: Join = None


def recorded_stretches(record, chunks=RECORDED_CHUNKS, log=print):
    """The recorded stretches of ``record``'s run, unprofiled and
    profiled, run once and kept as ``record.stretches["recorded_host"]``
    and ``["recorded"]``; None when the program has no recorder."""
    from torch.profiler import ProfilerActivity, profile

    from stylemesh_tpu_torch.utils import profiling

    stretches = record.stretches
    if "recorded" in stretches:
        return stretches["recorded_host"], stretches["recorded"]
    session = record.session
    if not hasattr(profiling, "recording"):
        return None
    t0 = time.perf_counter()
    loop = session.loop
    harness._to_chunk_start(loop)
    failed0 = loop.failed
    with profiling.recording() as program:
        wall, steps = _run_chunks(loop, chunks)
    host = stretches["recorded_host"] = RecordedStretch(
        wall, steps, loop.cut(), program=program)
    n0 = len(loop.spans.marks)
    loop.spans.mode = "mark"
    cuda = session.device.type == "cuda"
    with profile(activities=[ProfilerActivity.CUDA if cuda
                             else ProfilerActivity.CPU]) as prof:
        if cuda:
            _pad(session)
        with profiling.recording() as program:
            start = time.time_ns()
            wall, steps = _run_chunks(loop, chunks)
            session._sync()
            end = time.time_ns()
        if cuda:
            _pad(session)
    loop.spans.mode = None
    marks = loop.spans.marks[n0:]
    ops, launches, expected = launch_trace(prof) if cuda else ([], {}, ())
    join = Join(ops, launches, program.spans, marks, start, end, steps,
                program.counters, expected)
    stretch = stretches["recorded"] = RecordedStretch(
        wall, steps, loop.cut(), timeline=join.timeline, program=program,
        join=join)
    enqueue = host_s(host.program.spans, "train_step")
    log(f"[progtrace] unprofiled: {host.steps} steps, {host.seconds:.3f} s, "
        f"{host.seconds / max(host.steps, 1) * 1e3:.3f} ms a step, "
        f"train_step host ms median {statistics.median(enqueue) * 1e3:.3f}; profiled: "
        f"{steps} steps, {wall:.3f} s; {loop.failed - failed0} steps "
        f"failed; both run and joined in {time.perf_counter() - t0:.3f} s")
    busy = join.timeline.busy_s
    log(f"[progtrace] {len(join.ops)} device operations, {len(launches)} "
        f"launch records, {join.launches(UNLINKED)} operations unlinked, "
        f"{len(join.missing)} launches without one; launched outside every "
        f"span {join.device_s(OUTSIDE):.6f} s of {busy:.6f} s busy; "
        f"counters {json.dumps(join.counters)}")
    log("[progtrace] program_spans " + json.dumps(join.rows()))
    log("[progtrace] idle_gaps_program " + json.dumps(join.idle_gaps()))
    return host, stretch


def _run_chunks(loop, chunks):
    """``chunks`` whole chunks of the loop from a chunk's start, the last
    step read. Returns (seconds, steps)."""
    steps0 = loop.steps
    t0 = time.perf_counter()
    for _ in range(chunks):
        loop.step()
        while not loop.at_new_chunk:
            loop.step()
    loop.drain()
    return time.perf_counter() - t0, loop.steps - steps0


def _pad(session):
    """A fill on the device, a synchronize and a wait, inside the profile
    but outside the stretch: a profile can lose the device records of its
    first and last moments (seen with PyTorch 2.11), and those then fall
    here."""
    torch.ones(1, device=session.device).add_(1)
    session._sync()
    time.sleep(PAD_S)


def _stretches(record):
    if record.session.device.type != "cuda":
        return None
    return recorded_stretches(record)


def read(record):
    """The profiled recorded stretch's join, or None off CUDA or on a
    program without the recorder."""
    both = _stretches(record)
    return None if both is None else both[1].join


def enqueue_s(record):
    """The host seconds of each ``train_step`` span of the unprofiled
    recorded stretch, or None off CUDA or on a program without the
    recorder."""
    both = _stretches(record)
    return None if both is None else host_s(both[0].program.spans,
                                            "train_step")
