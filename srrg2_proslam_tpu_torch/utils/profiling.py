"""Profiling: scoped host timers and device traces.

Port of srrg2_proslam_tpu/utils/profiling.py (the PROFILE_TIME scoped
timers of the reference, enabled globally): a process-global registry of
named wall-clock accumulators, off unless ``enable()`` is called.  PyTorch
launches are asynchronous, so an enabled scope waits for the card on entry
and on exit: its time then holds the device work it launched, and the
synchronizes add to the run's time (take a run's ms/frame with profiling
off).

Usage:
    from srrg2_proslam_tpu_torch.utils import profiling
    profiling.enable()
    with profiling.profile_time("loop_detect"):
        ...
    print(profiling.report())

A device trace (torch.profiler; Chrome trace format, viewable in Perfetto):
    with profiling.device_trace("traces/run"):
        run_pipeline()
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch

_ENABLED = False
_ACCUM: Dict[str, list] = defaultdict(lambda: [0, 0.0])  # name -> [calls, secs]


def enable(on: bool = True) -> None:
    global _ENABLED
    _ENABLED = on


def reset() -> None:
    _ACCUM.clear()


def sync(device="cuda") -> None:
    """Wait for the work queued on ``device`` (nothing to wait for on the
    CPU, or before CUDA is first used), so a host clock read after it
    counts that work."""
    if torch.device(device).type == "cuda" and torch.cuda.is_initialized():
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def profile_time(name: str) -> Iterator[None]:
    """Scoped wall-clock timer (PROFILE_TIME analog). No-op unless enabled."""
    if not _ENABLED:
        yield
        return
    sync()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        sync()
        cell = _ACCUM[name]
        cell[0] += 1
        cell[1] += time.perf_counter() - t0


def stats() -> Dict[str, dict]:
    return {
        name: {"calls": calls, "total_s": total,
               "mean_ms": (total / calls * 1000.0) if calls else 0.0}
        for name, (calls, total) in _ACCUM.items()
    }


def report() -> str:
    """Human-readable per-scope timing table (mean ms, calls, total)."""
    lines = ["profile_time report:"]
    for name, s in sorted(stats().items(), key=lambda kv: -kv[1]["total_s"]):
        lines.append(
            f"  {name:32s} {s['mean_ms']:9.3f} ms/call  x{s['calls']:<6d} "
            f"total {s['total_s']:8.3f} s"
        )
    return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """Trace the host and, with a card, its kernels under torch.profiler,
    and write the Chrome trace to ``log_dir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
