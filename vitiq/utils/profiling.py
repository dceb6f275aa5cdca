"""Tracing / profiling utilities.

The reference's only observability is tqdm bars and wall-clock epoch timers
(ref: ViT/training/train.py:448-479, `format_time` utils.py:681-700). The
replacements:

  * StepTimer — dispatch-aware step timing: jax dispatch is async, so a
    naive `time.time()` around a step measures enqueue latency, not compute.
    StepTimer blocks on the step output before reading the clock and keeps
    p50/p90/best summaries.
  * trace_context — `jax.profiler` trace wrapper producing Perfetto/XProf
    dumps for any code region (SURVEY.md §5 plan).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import jax
import numpy as np


def format_time(seconds: float) -> str:
    """Human-readable duration (parity with ref utils.py:681-700)."""
    if seconds < 60:
        return f"{seconds:.1f}s"
    if seconds < 3600:
        m, s = divmod(seconds, 60)
        return f"{int(m)}m {s:.0f}s"
    h, rem = divmod(seconds, 3600)
    m = rem / 60
    return f"{int(h)}h {m:.0f}m"


@dataclass
class StepTimer:
    """Accumulates per-step wall times with correct async-dispatch semantics.

    Usage:
        timer = StepTimer()
        with timer.step():
            state, metrics = train_step(...)
            timer.sync(metrics["loss"])   # block before the clock stops
    """

    times: List[float] = field(default_factory=list)
    _t0: Optional[float] = None

    @contextlib.contextmanager
    def step(self):
        self._t0 = time.perf_counter()
        try:
            yield self
        finally:
            self.times.append(time.perf_counter() - self._t0)
            self._t0 = None

    def sync(self, value) -> None:
        jax.block_until_ready(value)

    def summary(self, skip_first: int = 1) -> Dict[str, float]:
        """p50/p90/best/mean over recorded steps (skipping compile steps)."""
        t = np.asarray(self.times[skip_first:] if len(self.times) > skip_first
                       else self.times)
        if len(t) == 0:
            return {}
        return {
            "steps": int(len(t)),
            "p50_s": float(np.median(t)),
            "p90_s": float(np.percentile(t, 90)),
            "best_s": float(t.min()),
            "mean_s": float(t.mean()),
        }


@contextlib.contextmanager
def trace_context(log_dir: str = "result/trace", enabled: bool = True):
    """jax.profiler trace for the wrapped region; view with XProf/Perfetto."""
    if not enabled:
        yield
        return
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
