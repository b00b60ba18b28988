"""Spans around the program's calls, and the reduction of one profiled
round's events, all kept in memory.

:class:`Spans` records a pair of CUDA events around every call of the
functions it patches and sums each stage's stream milliseconds.
:func:`profile_round` runs one round under ``torch.profiler`` and reduces
its events at once: the device operations (kernels, copies, fills) with
their streams and times, the time at least one of them ran (the union of
their intervals), and the device time by operation name. With the card's
activity alone the profiler records no host operation, so the round keeps
about its own length, read on the host's clock; with host activity too,
every host operation is recorded and the round runs slower, and the
longest idle gaps are labelled by the innermost host operation running
across them. No trace file is written.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
import unittest.mock as mock

import torch

# Profiler bookkeeping records on the device timeline that are no operation.
CUPTI_OVERHEAD = ("Command Buffer Full", "Buffer Flush", "Activity Buffer Request")
ROUND_RANGE = "bench.round"
RANGE_PREFIXES = ("bench.", "round.")  # host ranges, which the profiler mirrors on the device timeline


class Spans:
    """CUDA events around each call of the patched functions, by stage."""

    def __init__(self, targets: list, device):
        self.targets = targets  # (owner, attribute, stage)
        self.on_card = torch.device(device).type == "cuda"
        self.events = {stage: [] for _, _, stage in targets}

    def _around(self, fn, stage):
        def wrapped(*args, **kwargs):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kwargs)
            b.record()
            self.events[stage].append((a, b))
            return out
        return wrapped

    @contextlib.contextmanager
    def active(self):
        if not self.on_card:
            yield self
            return
        with contextlib.ExitStack() as stack:
            for owner, attr, stage in self.targets:
                stack.enter_context(mock.patch.object(owner, attr, self._around(getattr(owner, attr), stage)))
            yield self

    def ms(self) -> dict:
        """Each called stage's summed stream ms (call after a synchronize)."""
        return {stage: sum(a.elapsed_time(b) for a, b in pairs) for stage, pairs in self.events.items() if pairs}


@dataclasses.dataclass
class RoundTrace:
    window_s: float  # the traced round's length
    busy_s: float  # time at least one device operation ran
    ops: list  # (name, start_ns, end_ns, stream) of every device operation
    by_name: dict  # device seconds by operation name
    idle_gaps: list  # [label, seconds] of the longest gaps, longest first


def _union_ns(spans: list) -> int:
    total, end = 0, None
    for lo, hi in sorted(spans):
        if end is None or lo > end:
            total += hi - lo
            end = hi
        elif hi > end:
            total += hi - end
            end = hi
    return total


def _is_device_op(e) -> bool:
    from torch.autograd import DeviceType

    if e.device_type() != DeviceType.CUDA or e.name() in CUPTI_OVERHEAD:
        return False
    return not (e.is_user_annotation() or e.name().startswith(RANGE_PREFIXES))


def reduce_events(events, n_gaps: int = 10, window_s: float | None = None) -> RoundTrace:
    """Reduce the kineto events of one profiled round: the round is the
    host's :data:`ROUND_RANGE` range where the trace holds host events;
    without them (``window_s``, the round's length on the host's clock,
    given) it holds every device operation of the trace."""
    from torch.autograd import DeviceType

    host, ops, window = [], [], None
    for e in events:
        if _is_device_op(e):
            ops.append((e.name(), e.start_ns(), e.end_ns(), e.device_resource_id()))
        elif e.device_type() == DeviceType.CPU:
            if e.name() == ROUND_RANGE:
                window = (e.start_ns(), e.end_ns())
            elif e.name() not in CUPTI_OVERHEAD:
                host.append((e.start_ns(), e.end_ns(), e.name()))
    if window is None and window_s is None:
        raise RuntimeError("the profiled round's range is missing from the trace")
    if window is None:
        window = (min((a for _, a, _, _ in ops), default=0), max((b for _, _, b, _ in ops), default=0))
    lo, hi = window
    inside = [(max(a, lo), min(b, hi)) for _, a, b, _ in ops if b > lo and a < hi]
    busy = _union_ns(inside)
    by_name: dict = {}
    for name, a, b, _ in ops:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e9
    # idle gaps between the merged busy intervals, the window's ends included
    gaps, end = [], lo
    for a, b in sorted(inside):
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if hi > end:
        gaps.append((end, hi))
    gaps.sort(key=lambda g: g[0] - g[1])
    labelled = []
    for a, b in gaps[:n_gaps]:
        mid = (a + b) // 2
        covering = [(e - s, name) for s, e, name in host if s <= mid <= e]
        labelled.append(["host: " + (min(covering)[1] if covering else "python"), (b - a) / 1e9])
    return RoundTrace(window_s=(hi - lo) / 1e9 if window_s is None else window_s, busy_s=busy / 1e9, ops=ops,
                      by_name=by_name, idle_gaps=labelled)


def profile_round(run_round, device, host: bool) -> RoundTrace:
    """Run ``run_round()`` once under the profiler, synchronized, and reduce
    its events. ``host=False`` records the card's activity alone, and the
    round's length is the host clock's (off the card the profiler records
    the host whatever ``host`` says)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    on_card = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CUDA] if on_card else []
    if host or not on_card:
        activities.append(ProfilerActivity.CPU)
    if on_card:
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t = time.perf_counter()
        with record_function(ROUND_RANGE):
            run_round()
            if on_card:
                torch.cuda.synchronize()
        seconds = time.perf_counter() - t
    return reduce_events(prof.profiler.kineto_results.events(), window_s=None if host else seconds)


def kernel_seconds(trace: RoundTrace, symbol: str) -> tuple[float, int]:
    """Total device seconds and count of the operations whose name holds
    ``symbol`` (a kernel's function name)."""
    hits = [(b - a) / 1e9 for name, a, b, _ in trace.ops if symbol in name]
    return sum(hits), len(hits)
