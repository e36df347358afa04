"""torch.profiler over part of a window, reduced to what the metrics read.

Device busy time is the union of the device activities' intervals (kernels,
copies, memsets), the arithmetic of subgnn_tpu_torch/bench.py:profile_steps.
The reduction also gives each device operation's time by name, the device
activities launched by each CUDA graph replay, and the longest idle gaps
named by the host operation under way in each.
"""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple


def union_us(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def gaps(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """(start, end) of each idle stretch between the union's pieces."""
    out, end = [], None
    for a, b in sorted(intervals):
        if end is not None and a > end:
            out.append((end, a))
        end = b if end is None else max(end, b)
    return out


class Trace:
    """Start and stop a profiler; `reduce()` after stop."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.wall_s = 0.0

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self.prof = profile(activities=acts)
        self.prof.start()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.wall_s = time.perf_counter() - self._t0
        self.prof.stop()

    def reduce(self) -> Dict:
        from torch.autograd import DeviceType
        events = list(self.prof.events())
        dev = [e for e in events if e.device_type == DeviceType.CUDA]
        host = [e for e in events if e.device_type == DeviceType.CPU]
        return reduce_events(dev, host, self.wall_s)


def reduce_events(dev, host, wall_s: float) -> Dict:
    """The trace's numbers from device and host FunctionEvents."""
    iv = [(e.time_range.start, e.time_range.end) for e in dev]
    by_name: Dict[str, float] = defaultdict(float)
    count: Dict[str, int] = defaultdict(int)
    for e in dev:
        by_name[e.name] += (e.time_range.end - e.time_range.start) / 1e6
        count[e.name] += 1
    # device activities of each graph replay: an activity's id is the
    # correlation id of the runtime call that launched it
    launches = sorted((e for e in host if e.name == "cudaGraphLaunch"),
                      key=lambda e: e.time_range.start)
    by_corr: Dict[int, int] = defaultdict(int)
    for e in dev:
        by_corr[e.id] += 1
    per_launch = [by_corr.get(e.id, 0) for e in launches]
    host_iv = [(e.time_range.start, e.time_range.end, e.name) for e in host]
    idle = []
    for a, b in sorted(gaps(iv), key=lambda x: x[0] - x[1])[:10]:
        mid = (a + b) / 2
        under = [x for x in host_iv if x[0] <= mid <= x[1]]
        # the innermost host operation under way at the gap's middle
        name = min(under, key=lambda x: x[1] - x[0])[2] if under else \
            "no host operation"
        idle.append((name, (b - a) / 1e6))
    return {"busy_s": union_us(iv) / 1e6, "window_s": wall_s,
            "activities": len(dev), "by_name": dict(by_name),
            "count": dict(count), "graph_launches": len(launches),
            "per_launch": per_launch, "idle_gaps": idle}


def breakdown(red: Dict) -> Dict:
    """The result line's breakdown: the 10 device operations with the most
    time, and the 10 longest idle gaps by what the host was doing."""
    ops = sorted(red["by_name"].items(), key=lambda x: -x[1])[:10]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in red["idle_gaps"][:10]]}


def device_time(red: Dict, match: str) -> Tuple[float, int]:
    """(seconds, activities) of the device operations whose name holds
    `match`."""
    s = sum(v for k, v in red["by_name"].items() if match in k)
    n = sum(v for k, v in red["count"].items() if match in k)
    return s, n


def graph_activities(red: Dict) -> Optional[List[int]]:
    """Device activities of each graph replay, where the trace links them
    to their launch (None where it does not)."""
    per = red["per_launch"]
    return per if per and any(per) else None
