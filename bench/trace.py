"""A traced stretch of calls, read from `torch.profiler`'s timeline.

Each call runs inside a `bench.call` span.  The traced window runs from
the first span's start to the last span's end.  Device operations are the
profiler's kernels, copies and sets on the card; the device is busy where
one runs and idle elsewhere.  Each idle gap is put down to what the host
was doing at its middle: the innermost host event on the calling thread
that spans that instant.
"""
from __future__ import annotations

import bisect
import collections
import time

import torch

CALL = "bench.call"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_KINDS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
              "python_function")
TOP = 10
NAME_CHARS = 200
_BACK = 512        # host events looked back at for one gap


def profile_calls(call, seconds: float):
    """Run `call` under the profiler until `seconds` have passed on the
    host clock; returns (the last call's result, `summarize`'s dict)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    calls, out = 0, None
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        while calls == 0 or time.perf_counter() - t0 < seconds:
            with record_function(CALL):
                out = call()
            calls += 1
    return out, summarize(prof.profiler.kineto_results.events(), calls)


def _kind(e) -> str:
    """The event's kineto activity type, or the same worked out from its
    device and name where the binding lacks `activity_type`."""
    try:
        return e.activity_type()
    except AttributeError:
        pass
    on_card = e.device_type() == torch.autograd.DeviceType.CUDA
    if e.is_user_annotation():
        return "gpu_user_annotation" if on_card else "user_annotation"
    if on_card:
        name = e.name()
        return ("gpu_memcpy" if name.startswith("Memcpy") else
                "gpu_memset" if name.startswith("Memset") else "kernel")
    return "cuda_runtime" if e.name().startswith("cuda") else "cpu_op"


def _end(e) -> int:
    return e.start_ns() + e.duration_ns()


def _top(totals: dict) -> list:
    return [[name[:NAME_CHARS], s] for name, s in
            sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]]


def summarize(events, calls: int) -> dict:
    """calls, window_s, busy_s, kernels (count), kernel_s (their summed
    time), device_ops and idle_gaps ([name, seconds] lists, the largest
    first) of one traced stretch."""
    kinds = [(_kind(e), e) for e in events]
    spans = [e for k, e in kinds if k == "user_annotation"
             and e.name() == CALL]
    w0 = min(e.start_ns() for e in spans)
    w1 = max(_end(e) for e in spans)
    thread = spans[0].start_thread_id()
    dev = sorted(((k, e) for k, e in kinds if k in DEVICE_KINDS
                  and _end(e) > w0 and e.start_ns() < w1),
                 key=lambda ke: ke[1].start_ns())
    ops = collections.defaultdict(float)
    kernels, kernel_ns = 0, 0
    busy_ns, gaps = 0, []
    cur0 = cur1 = w0
    for k, e in dev:
        a, b = max(e.start_ns(), w0), min(_end(e), w1)
        ops[e.name()] += (b - a) * 1e-9
        if k == "kernel":
            kernels += 1
            kernel_ns += b - a
        if a > cur1:
            busy_ns += cur1 - cur0
            gaps.append((cur1, a))
            cur0 = a
        cur1 = max(cur1, b)
    busy_ns += cur1 - cur0
    if w1 > cur1:
        gaps.append((cur1, w1))

    host = sorted((e for k, e in kinds if k in HOST_KINDS
                   and e.start_thread_id() == thread),
                  key=lambda e: e.start_ns())
    starts = [e.start_ns() for e in host]
    idle = collections.defaultdict(float)
    for a, b in gaps:
        mid = (a + b) // 2
        name = "(no host event)"
        j = bisect.bisect_right(starts, mid) - 1
        for i in range(j, max(-1, j - _BACK), -1):
            if _end(host[i]) >= mid:
                name = host[i].name()
                break
        idle[name] += (b - a) * 1e-9
    return {"calls": calls, "window_s": (w1 - w0) * 1e-9,
            "busy_s": busy_ns * 1e-9, "kernels": kernels,
            "kernel_s": kernel_ns * 1e-9, "device_ops": _top(ops),
            "idle_gaps": _top(idle)}
