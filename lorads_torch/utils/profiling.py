"""Timers, counters, device traces and roofline accounting (port of
lorads_tpu/utils/profiling.py).

``PhaseTimers``, ``Stopwatch`` and ``CGStats`` are lorads_tpu's.
``device_trace`` runs ``torch.profiler`` (CPU and CUDA activities on the
card, the CPU alone on the CPU) and writes a Chrome / TensorBoard trace
(``*.pt.trace.json``) into its directory; ``lost_kernels`` lists the
launches such a trace holds no kernel event of.  ``roofline`` and
``format_roofline`` keep lorads_tpu's fields; ``chip_peaks`` gives the
datasheet peaks of the NVIDIA H100 SXM 80GB beside the card's power
limit, and raises for a device it has no datasheet for.  lorads_tpu's
``compiled_cost`` reads XLA's cost model, which torch has no counterpart
of: the caller counts a function's flops and bytes itself, as
chip_smoke.py's ``bound_of`` does.
"""

from __future__ import annotations

import contextlib
import dataclasses
import subprocess
import time
from typing import Dict, Optional

import torch


@dataclasses.dataclass
class PhaseTimers:
    """Per-phase wall-clock accumulators (main.c:314-317 analogue)."""

    read: float = 0.0
    presolve: float = 0.0
    alm: float = 0.0
    admm: float = 0.0
    reopt: float = 0.0
    dual_infeas: float = 0.0
    total: float = 0.0

    def as_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


class Stopwatch:
    """Accumulating context-manager timer."""

    def __init__(self):
        self.elapsed = 0.0

    @contextlib.contextmanager
    def __call__(self):
        t0 = time.time()
        try:
            yield
        finally:
            self.elapsed += time.time() - t0


@contextlib.contextmanager
def device_trace(logdir: Optional[str], device=None):
    """Trace what runs inside with ``torch.profiler`` and write the trace
    into ``logdir`` (viewable in TensorBoard's profiler plugin or
    chrome://tracing).  ``device``: "cuda" adds the CUDA activity (the
    default when a GPU is present), "cpu" traces the CPU alone; with the
    CUDA activity a warm-up step comes first (``timing.profiled``), so
    that the trace holds the block's first kernels too.  No-op when
    logdir is None, so runs without a trace pay nothing."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, tensorboard_trace_handler

    from lorads_torch.timing import profiled

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profiled(activities, on_trace_ready=tensorboard_trace_handler(
            logdir, worker_name="lorads_torch")):
        yield


def lost_kernels(events) -> list:
    """The kernel launches (``cudaLaunchKernel*`` runtime events) of a
    trace's ``traceEvents`` that no kernel event shares a correlation id
    with: kernels the trace did not record."""
    ran = {e.get("args", {}).get("correlation") for e in events
           if e.get("cat") == "kernel"}
    return [e for e in events if e.get("cat") == "cuda_runtime"
            and e.get("name", "").startswith("cudaLaunchKernel")
            and e.get("args", {}).get("correlation") not in ran]


@dataclasses.dataclass
class CGStats:
    """Cumulative CG statistics (def_lorads_cgs.h:43-46 analogue)."""

    iters: int = 0
    solves: int = 0

    def add(self, iters: int, solves: int = 1):
        self.iters += int(iters)
        self.solves += solves


# Datasheet peaks (NVIDIA H100 SXM 80GB): flop/s by type outside the
# tensor cores (f64, f32) and on them (f64_tensor, tf32, bf16, dense),
# and the HBM3 rate in bytes/s.  A card run below its 700 W maximum
# reaches less under load: the power limit is reported beside them.
H100_SXM_PEAKS = {"f64": 34e12, "f64_tensor": 67e12, "f32": 67e12,
                  "tf32": 494e12, "bf16": 989e12, "hbm": 3.35e12}


def chip_peaks(device=None) -> Dict[str, float]:
    """The datasheet peaks of the card (``device``, default "cuda"), with
    ``name`` (the datasheet's) and ``card`` (nvidia-smi's name and power
    limit).  Raises ValueError for the CPU or a card with no datasheet
    here."""
    d = torch.device(device or "cuda")
    if d.type != "cuda" or not torch.cuda.is_available():
        raise ValueError(f"no datasheet peaks for device {d}")
    kind = torch.cuda.get_device_name(d)
    if "H100" not in kind:
        raise ValueError(f"no datasheet peaks for {kind}")
    from lorads_torch.timing import card_line
    try:
        card = card_line()
    except (OSError, subprocess.CalledProcessError,
            subprocess.TimeoutExpired):   # no nvidia-smi: limit unknown
        card = f"{kind}, power limit not read"
    return dict(H100_SXM_PEAKS, name="NVIDIA H100 SXM 80GB datasheet",
                card=card)


def roofline(flops: float, bytes_: float, wall_s: float,
             dtype: str = "f32", device=None) -> Dict[str, float]:
    """Roofline summary for one measured dispatch (or iteration).

    target_s  -- the speed-of-light time max(flops/peak, bytes/bw):
                 below it the measurement is impossible, near it the
                 kernel is compute- or bandwidth-bound, far above it
                 the kernel is latency/occupancy-bound.
    mfu       -- achieved fraction of peak FLOP/s.
    bw_frac   -- achieved fraction of peak HBM bandwidth.
    headroom  -- wall_s / target_s (1.0 = speed of light).
    """
    peaks = chip_peaks(device)
    peak_f = peaks.get(dtype, peaks["f32"])
    t_compute = flops / peak_f
    t_memory = bytes_ / peaks["hbm"]
    target = max(t_compute, t_memory)
    return {
        "flops": flops, "bytes": bytes_, "wall_s": wall_s,
        "target_s": target,
        "bound": "compute" if t_compute >= t_memory else "memory",
        "mfu": flops / peak_f / wall_s if wall_s > 0 else 0.0,
        "bw_frac": bytes_ / peaks["hbm"] / wall_s if wall_s > 0 else 0.0,
        "headroom": wall_s / target if target > 0 else float("inf"),
    }


def format_roofline(label: str, r: Dict[str, float]) -> str:
    """One aligned report line (printed alongside wall-clock)."""
    return (f"{label:>24}: {r['wall_s'] * 1e3:8.3f} ms  "
            f"target {r['target_s'] * 1e3:7.3f} ms "
            f"({r['bound']}-bound)  x{r['headroom']:.1f} off  "
            f"MFU {r['mfu'] * 100:5.2f}%  BW {r['bw_frac'] * 100:5.1f}%  "
            f"[{r['flops'] / 1e9:.2f} GF, {r['bytes'] / 1e6:.1f} MB]")
