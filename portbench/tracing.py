"""The traced run: whole rounds under ``torch.profiler``, read into the
record that the per-layer metric readers take.

On the card the profiler records the device's kernels, copies and sets and
the host's CUDA runtime calls (CUPTI), not the host's aten ops: recording
those cost a fedyolov3 round about a third of its time, CUPTI alone about a
tenth. Each round runs inside the benchmark's own span ``portbench.round``,
timed on the host's clock, which is the profiler's. The profiler misses
launches near a trace's edges, so one guard round at each end is traced and
left out of every number. A device operation belongs to the round whose
span holds its start: every round ends on a host sync, so no round's work
runs into the next one's span.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

SPAN = "portbench.round"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


def traced_rounds(run_round, batches: list, on_card: bool, guard: int = 1) -> dict:
    """Run ``batches`` (guard rounds included at both ends) under the
    profiler -> the record: {"rounds": [{"start_ns", "end_ns",
    "samples"}], "ops": [(name, kind, start_ns, end_ns)] of the device,
    "host": [(name, start_ns, end_ns)], "busy_s", "window_s"}, of the
    rounds between the guards; "samples" and "failed" (non-finite losses)
    of every round. ``on_card`` False (the benchmark's CPU
    tests) traces the host's ops alone."""
    from torch.profiler import ProfilerActivity, profile, record_function

    samples, spans, losses = [], [], []
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    sync()
    with profile(activities=[ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU]) as prof:
        for batch in batches:
            start = time.time_ns()
            with record_function(SPAN):
                loss, n = run_round(batch)
            spans.append((start, time.time_ns()))
            samples.append(n)
            losses.append(loss)
        sync()
    rec = read_events(prof.profiler.kineto_results.events(), spans, samples, guard)
    rec.update(samples=samples, failed=sum(not math.isfinite(x) for x in losses))
    return rec


def _kind(e) -> str:
    """Kineto's activity type of an event; for a torch that does not expose
    it, inferred from the device, the annotation flag and the name."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    user = e.is_user_annotation() if hasattr(e, "is_user_annotation") else e.name() == SPAN
    if e.device_type() == torch.autograd.DeviceType.CUDA:
        if user or e.name() == SPAN:
            return "gpu_user_annotation"
        return ("gpu_memcpy" if e.name().startswith("Memcpy") else
                "gpu_memset" if e.name().startswith("Memset") else "kernel")
    return "user_annotation" if user else "cpu_op"


def read_events(events, spans: list[tuple[int, int]], samples: list[int], guard: int) -> dict:
    """The profiler's events and the rounds' host spans -> the record of
    :func:`traced_rounds`."""
    ops, host, kinds = [], [], {}
    for e in events:
        kind = _kind(e)
        kinds[kind] = kinds.get(kind, 0) + 1
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if kind in DEVICE_KINDS:
                ops.append((e.name(), kind, e.start_ns(), e.start_ns() + e.duration_ns()))
        elif e.name() != SPAN:
            host.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    kept = range(guard, len(spans) - guard)
    lo, hi = spans[guard][0], spans[len(spans) - guard - 1][1]
    rounds = [{"start_ns": spans[i][0], "end_ns": spans[i][1], "samples": samples[i]} for i in kept]
    kept_ops = sorted((o for o in ops if lo <= o[2] <= hi), key=lambda o: o[2])
    host = [h for h in host if h[2] >= lo and h[1] <= hi]
    busy, gaps = _union(kept_ops, lo, hi)
    return {"rounds": rounds, "ops": kept_ops, "host": host, "busy_s": busy / 1e9,
            "window_s": (hi - lo) / 1e9, "gaps": gaps, "kinds": kinds, "device_ops": len(ops)}


def _union(ops, lo: int, hi: int):
    """(ns in which some device op ran within [lo, hi], the idle gaps
    between the merged intervals as (start, end))."""
    busy, gaps, cur_s, cur_e = 0, [], None, lo
    for _, _, s, e in ops:
        s, e = max(s, lo), min(e, hi)
        if cur_s is None or s > cur_e:
            if cur_s is not None:
                busy += cur_e - cur_s
            if s > cur_e:
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_s is not None:
        busy += cur_e - cur_s
    if hi > cur_e:
        gaps.append((cur_e, hi))
    return busy, gaps


def breakdown(rec: dict, top: int = 10) -> dict:
    """The device operations that took the most time, and the longest
    idle gaps named by the innermost host event traced at their midpoint
    (on the card a CUDA runtime call; "host" where none was running, so
    the host was in Python or aten)."""
    by_name: dict[str, float] = {}
    for name, _, s, e in rec["ops"]:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    names = [h[0] for h in rec["host"]]
    starts = np.array([h[1] for h in rec["host"]], dtype=np.int64)
    ends = np.array([h[2] for h in rec["host"]], dtype=np.int64)
    idle = []
    for s, e in sorted(rec["gaps"], key=lambda g: g[0] - g[1])[:top]:
        mid = (s + e) // 2
        inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
        name = names[inside[np.argmin(ends[inside] - starts[inside])]] if inside.size else "host"
        idle.append([name, (e - s) / 1e9])
    return {"device_ops": [[n, v] for n, v in device_ops], "idle_gaps": idle}
