"""Timing on the card, shared by ``chip_smoke.py``, ``profile_solve.py``
and the probe driver.

* ``card_line``: the card's name and power limit, as
  ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
  prints them; every kept number carries it.
* ``cuda_time_ms``: ms per dispatched call, CUDA events around ``reps``
  back-to-back calls after ``warmup`` calls: the host's launch included.
* ``device_time_ms``: ms per call on the device alone: ``reps`` calls in
  one CUDA graph replayed between two CUDA events
  (``graph_time_ms``), or, for a call a graph cannot hold because it
  reads the device from the host (``torch.segment_reduce``), its kernels'
  own time from ``torch.profiler`` (``profiler_time_ms``).
"""

from __future__ import annotations

import subprocess

import torch


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def graph_time_ms(fn, reps=20):
    """Device ms per call: ``reps`` calls captured in one CUDA graph and
    replayed between two CUDA events, so no host dispatch is timed.  None
    when the call cannot be captured."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
    except RuntimeError:
        torch.cuda.synchronize()
        return None
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def profiler_time_ms(fn, reps=20):
    """Device ms per call for a call a graph cannot hold: the kernels' and
    copies' own device time over ``reps`` calls, from ``torch.profiler``
    (no gaps between them); None if the profiler saw no device event."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(ev.self_device_time_total for ev in prof.key_averages()
             if ev.device_type != torch.autograd.DeviceType.CPU)
    return us * 1e-3 / reps if us > 0 else None


def device_time_ms(fn):
    """(device ms per call, how): a CUDA graph's replay, else the
    profiler's device time."""
    ms = graph_time_ms(fn)
    if ms is not None:
        return ms, "graph"
    return profiler_time_ms(fn), "profiler"
