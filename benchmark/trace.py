"""The traced window: ``torch.profiler`` (CPU and CUDA activities) around a
few steady iterations, exported as a Chrome trace to a fixed file inside
the checkout and read back into device intervals, host operations and the
launch that made each device operation.

A device operation belongs to a host operation or span (such as
``aten::convolution_backward`` or torch's ``Optimizer.step#Adam.step``)
when the runtime call that launched it, matched by its correlation id,
lies inside it on the same host thread.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

WINDOW_SPAN = "benchmark.traced_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


class Trace:
    def __init__(self, events: List[dict]) -> None:
        self.device: List[Tuple[str, float, float, Optional[int]]] = []
        self.host: List[Tuple[str, float, float]] = []
        threads: Dict[object, List[Tuple[float, float, str]]] = {}
        launches: List[Tuple[object, float, int]] = []
        self.window = (0.0, 0.0)
        for e in events:
            cat, ph = e.get("cat"), e.get("ph")
            if ph != "X":
                continue
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            if cat in DEVICE_CATS:
                self.device.append((e["name"], ts, ts + dur, e.get("args", {}).get("correlation")))
            elif cat in ("cuda_runtime", "cuda_driver"):
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launches.append((e.get("tid"), ts, corr))
            elif cat in HOST_CATS:
                if e["name"] == WINDOW_SPAN:
                    self.window = (ts, ts + dur)
                else:
                    self.host.append((e["name"], ts, ts + dur))
                    threads.setdefault(e.get("tid"), []).append((ts, ts + dur, e["name"]))
        lo, hi = self.window
        self.device = [d for d in self.device if d[2] > lo and d[1] < hi]
        self.device.sort(key=lambda d: d[1])
        self.stack = _launch_stacks(threads, launches)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals inside the window."""
        lo, hi = self.window
        merged: List[List[float]] = []
        for _, a, b, _ in self.device:
            a, b = max(a, lo), min(b, hi)
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def idle_gaps(self) -> List[Tuple[float, float]]:
        lo, hi = self.window
        edges = [lo]
        for a, b in self.busy_intervals():
            edges += [a, b]
        edges.append(hi)
        return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]

    def device_seconds(self, match: Callable[[str], bool]) -> float:
        return sum(b - a for name, a, b, _ in self.device if match(name)) * 1e-6

    def device_seconds_under(self, match: Callable[[str], bool]) -> float:
        """Device time of the operations launched inside a host operation or
        span whose name ``match`` accepts."""
        total = 0.0
        for _, a, b, corr in self.device:
            if any(match(name) for name in self.stack.get(corr, ())):
                total += b - a
        return total * 1e-6

    def top_device_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for name, a, b, _ in self.device:
            by[name] = by.get(name, 0.0) + (b - a) * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def longest_gaps(self, n: int = 10) -> List[List]:
        """The longest idle gaps, each named by the innermost host operation
        that spans its middle."""
        out = []
        for a, b in sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])[:n]:
            mid = (a + b) / 2
            inside = [(e - s, name) for name, s, e in self.host if s <= mid <= e]
            out.append([min(inside)[1] if inside else "host: no operation", (b - a) * 1e-6])
        return out


def _launch_stacks(threads, launches) -> Dict[int, Tuple[str, ...]]:
    """For each launch's correlation id, the names of the host operations
    open on its thread when it was made (operations on one thread nest)."""
    out: Dict[int, Tuple[str, ...]] = {}
    by_thread: Dict[object, List[Tuple[float, int]]] = {}
    for tid, ts, corr in launches:
        by_thread.setdefault(tid, []).append((ts, corr))
    for tid, items in by_thread.items():
        ops = sorted(threads.get(tid, []), key=lambda o: (o[0], -o[1]))
        stack: List[Tuple[float, float, str]] = []
        j = 0
        for ts, corr in sorted(items):
            while j < len(ops) and ops[j][0] <= ts:
                while stack and stack[-1][1] < ops[j][0]:
                    stack.pop()
                stack.append(ops[j])
                j += 1
            while stack and stack[-1][1] < ts:
                stack.pop()
            out[corr] = tuple(o[2] for o in stack)
    return out


def record(fn: Callable[[], None], path: Path, device: torch.device) -> Trace:
    """Run ``fn`` under the profiler inside the window span, synchronise,
    export to ``path`` and read it back."""
    from torch.profiler import ProfilerActivity, profile, record_function

    path.parent.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(WINDOW_SPAN):
            fn()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        doc = json.load(f)
    return Trace(doc["traceEvents"] if isinstance(doc, dict) else doc)


def patterns(path: Path) -> Sequence[str]:
    """Lower-case substrings, one a line, ``#`` starting a comment."""
    out = []
    for line in path.read_text().splitlines():
        line = line.split("#", 1)[0].strip().lower()
        if line:
            out.append(line)
    return out
