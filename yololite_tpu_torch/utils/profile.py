"""Wall-clock timer and device traces (port of yololite_tpu/utils/profile.py).

CUDA work is asynchronous: a timed block that launches device work should
end with a host copy of its result (as the predictor's `.cpu()` does), or
the timer measures only the launch.
"""

from __future__ import annotations

import time
from contextlib import ContextDecorator, contextmanager
from pathlib import Path


class Profile(ContextDecorator):
    """Accumulating wall-clock timer: `with Profile() as p: ...` then p.dt / p.t."""

    def __init__(self, t: float = 0.0):
        self.t = t  # cumulative seconds
        self.dt = 0.0  # last interval

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.dt = time.perf_counter() - self.start
        self.t += self.dt
        return False

    def __str__(self):
        return f"Elapsed time is {self.t} s"


@contextmanager
def trace_to(log_dir: str):
    """Context manager: a torch.profiler trace of the block (CPU, and CUDA when a card is visible) written to
    `log_dir` as a Chrome trace (`trace.json`, open it in chrome://tracing or Perfetto)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))
