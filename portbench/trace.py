"""Reduce a ``torch.profiler`` trace of the profiled stretch to what the
per-layer readers and the result's ``breakdown`` need.

The profiled stretch runs after the window, first unprofiled (its host
clock), then twice under the profiler, each time behind a few
calls made under the profiler and discarded (its warm-up: the profiler's
own start-up costs, hundreds of ms with the card's tracing, stay out of the
stretch) and inside a ``record_function(WINDOW)`` span that ends after a
``torch.cuda.synchronize()``.  The first run records the card's activity
alone, which slows the host little: busy time is the union of its device
operations' intervals (kernels, copies and fills) and the window the
stretch's length on the host clock; :func:`pace` says how its calls ran
against the window's.  The second records the host's ops as well, which
slows the host a lot (a train step takes several times as long), so only
what needs the host's ops comes from it: an idle gap is a stretch of its
span with no device operation, labelled by the innermost host op running
at its midpoint on the thread of the span.  The 3x3 stride-1 SAME
convolutions are read from the host ops ``aten::convolution`` and
``umics::conv3x3_nhwc`` with their recorded shapes (and, for the former,
its recorded stride, padding, dilation, transposition and groups); each
op's device time is the time of the device operations the profiler links
to it or to the ops under it.
"""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import torch
from torch.autograd import DeviceType

__all__ = ["WINDOW", "ConvOp", "Profile", "measure", "pace", "reduce", "describe"]

WINDOW = "portbench.window"
CONV_OPS = ("aten::convolution", "umics::conv3x3_nhwc")
TOP = 10


@dataclass
class ConvOp:
    """One 3x3 stride-1 SAME conv of the stretch, NHWC terms."""
    name: str
    n: int
    h: int
    w: int
    cin: int
    cout: int
    device_s: float


@dataclass
class Profile:
    calls: int
    window_s: float
    busy_s: float
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)
    convs: List[ConvOp] = field(default_factory=list)
    conv_ops_seen: int = 0
    conv_ops_without_device_time: int = 0
    plain_s: float = 0.0   # the same calls unprofiled, host clock


def _profile(device: torch.device, call: Callable[[int], None], n: int, detail: bool,
             end: Optional[Callable[[], None]]):
    """``call(0..n-1)`` under the profiler, inside the :data:`WINDOW` span and
    ending in ``end()`` and a synchronise, behind ``call(n..)`` made under
    the profiler's warm-up and left out; -> (profiler, the stretch's seconds
    on the host clock).  ``detail``: host ops with their shapes beside the
    card's activity; else the card's activity alone, which costs the host
    little."""
    acts = [torch.profiler.ProfilerActivity.CUDA] if device.type == "cuda" else []
    if detail or not acts:
        acts.append(torch.profiler.ProfilerActivity.CPU)

    def settle():
        if end is not None:
            end()
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    once = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=acts, record_shapes=detail, schedule=once) as prof:
        for i in range(max(2, n // 4)):
            call(n + i)
        settle()
        prof.step()
        with torch.profiler.record_function(WINDOW):
            t0 = time.perf_counter()
            for i in range(n):
                call(i)
            settle()
            seconds = time.perf_counter() - t0
        prof.step()
    return prof, seconds


def measure(device: torch.device, call: Callable[[int], None], calls: int, detail_calls: int,
            end: Optional[Callable[[], None]] = None) -> "Profile":
    """Time ``calls`` calls unprofiled, profile as many with the card's
    activity alone (busy time, window, device operations: what the run
    costs with little tracing), then ``detail_calls`` with the host's ops
    and shapes (the idle gaps' labels, the 3x3 convs).  ``end()`` closes
    each stretch (a last fetch)."""
    t0 = time.perf_counter()
    for i in range(calls):
        call(i)
    if end is not None:
        end()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    plain = time.perf_counter() - t0
    light, seconds = _profile(device, call, calls, False, end)
    heavy, _ = _profile(device, call, detail_calls, True, end)
    p = reduce(light, seconds, heavy, calls)
    p.plain_s = plain
    return p


def pace(p: "Profile", window_s: float, window_calls: int) -> str:
    """How the light stretch ran against the window: its host seconds a call
    over the window's (near 1 when it ran as the window did; beside it the
    same calls unprofiled, which tells the profiler's cost from the state
    the process is in after the window), and its busy
    device seconds a call over the window's host seconds a call (over 1: the
    tracing slowed the device's work itself, so the stretch's busy time and
    idle share do not describe the window)."""
    per_call = window_s / window_calls
    return (f"host {p.window_s / p.calls / per_call:.4f} (unprofiled "
            f"{p.plain_s / p.calls / per_call:.4f}), busy {p.busy_s / p.calls / per_call:.4f}"
            f" of the window's seconds a call")


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _labels(ops, times: List[float]) -> List[str]:
    """The innermost of the properly nested ``ops`` running at each of
    ``times`` ("python" where none is), in one sweep."""
    points = [(e.time_range.start, 0, e) for e in ops] + [(e.time_range.end, 2, e) for e in ops]
    points += [(t, 1, i) for i, t in enumerate(times)]
    points.sort(key=lambda p: (p[0], p[1]))
    stack, out = [], ["python"] * len(times)
    for _, kind, x in points:
        if kind == 0:
            stack.append(x)
        elif kind == 2:
            if any(e is x for e in stack):
                while stack.pop() is not x:
                    pass
        elif stack:
            out[x] = stack[-1].name
    return out


def _conv_op(e) -> Optional[ConvOp]:
    """The NHWC terms of a 3x3 stride-1 SAME conv op, else None."""
    shapes = e.input_shapes
    if len(shapes) < 2 or len(shapes[0]) != 4 or len(shapes[1]) != 4:
        return None
    if e.name == "umics::conv3x3_nhwc":
        (n, h, w, cin), (kh, kw, _, cout) = shapes[0], shapes[1]
    else:
        args = list(getattr(e, "concrete_inputs", None) or [])
        if len(args) < 9:
            return None
        stride, padding, dilation, transposed, groups = args[3], args[4], args[5], args[6], args[8]
        (n, cin, h, w), (cout, _, kh, kw) = shapes[0], shapes[1]
        if (list(stride) != [1, 1] or list(padding) != [1, 1] or list(dilation) != [1, 1]
                or transposed or groups != 1):
            return None
    if (kh, kw) != (3, 3):
        return None
    return ConvOp(e.name, n, h, w, cin, cout, e.device_time_total / 1e6)


def _device_ops(events) -> list:
    # the card's timeline also carries the host's annotations (the window
    # span, the optimizer's step): those are not device operations
    notes = {e.name for e in events if getattr(e, "is_user_annotation", False)} | {WINDOW}
    return [e for e in events if e.device_type == DeviceType.CUDA and e.name not in notes
            and not getattr(e, "is_user_annotation", False)]


def reduce(light, seconds: float, heavy, calls: int) -> Profile:
    """The :class:`Profile` of :func:`measure`'s two stretches of ``calls``."""
    device = _device_ops(light.events())
    busy = _union([(e.time_range.start, e.time_range.end) for e in device])
    by_name = defaultdict(float)
    for e in device:
        by_name[e.name] += (e.time_range.end - e.time_range.start) / 1e6

    events = heavy.events()
    window = next(e for e in events if e.name == WINDOW)
    w0, w1 = window.time_range.start, window.time_range.end
    # the profiler's own step spans enclose the window: not the host's work
    host = [e for e in events if e.device_type == DeviceType.CPU and not e.is_async
            and e.thread == window.thread and e.name != WINDOW
            and not e.name.startswith("ProfilerStep")]
    traced = _union([(max(e.time_range.start, w0), min(e.time_range.end, w1))
                     for e in _device_ops(events)
                     if e.time_range.end > w0 and e.time_range.start < w1])
    edges = [w0] + [t for seg in traced for t in seg] + [w1]
    idle = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    gaps = defaultdict(float)
    for (a, b), label in zip(idle, _labels(host, [(a + b) / 2 for a, b in idle])):
        gaps[label] += (b - a) / 1e6
    convs, seen, silent = [], 0, 0
    for e in host:
        if e.name not in CONV_OPS:
            continue
        parent = e.cpu_parent
        while parent is not None and parent.name != e.name:
            parent = parent.cpu_parent
        if parent is not None:
            continue  # a nested record of the same op
        seen += 1
        op = _conv_op(e)
        if op is None:
            continue
        if op.device_s <= 0:
            silent += 1
        convs.append(op)
    top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:TOP]  # noqa: E731
    return Profile(calls, seconds, sum(b - a for a, b in busy) / 1e6,
                   top(by_name), top(gaps), convs, seen, silent)


def describe(p: Profile) -> str:
    """One line on what the trace held, for standard error."""
    by_op = defaultdict(int)
    for c in p.convs:
        by_op[c.name] += 1
    return (f"{p.calls} calls, busy {p.busy_s:.6f} of {p.window_s:.6f} s; conv ops "
            f"{p.conv_ops_seen}, 3x3 SAME {dict(by_op)}, without device time "
            f"{p.conv_ops_without_device_time}")
