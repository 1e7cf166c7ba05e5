"""Profiling and tracing (the port's copy of ``zkdl_tpu/utils/profiling.py``).

- ``PhaseTimer``: accumulating named phase timers; each phase
  ends with a ``torch.cuda.synchronize`` of the timer's card (the JAX
  package's fence reads the phase's outputs back to the host), so a phase's
  time includes its device work. The demo and the bench time their phases
  with it;
- ``trace``: a context manager around ``torch.profiler`` (CPU activity, and
  CUDA activity on a card) that yields the profiler and, given a directory,
  writes a Chrome trace (``trace.json``) there. ``profile_prove`` reads its
  events. If the profiler cannot start, it raises.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


class PhaseTimer:
    """Accumulating wall-clock timers keyed by phase name."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        return "\n".join(f"{name:28s} {self.totals[name]*1e3:10.1f} ms  x{self.counts[name]}"
                         for name in sorted(self.totals, key=lambda n: -self.totals[n]))


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """torch.profiler over the block (CPU activity, and CUDA activity when a
    card is present). Yields the profiler; with log_dir, writes
    log_dir/trace.json at the end."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
