"""Profiling and tracing hooks (port of starvector_tpu/utils/profiling.py).

  * `trace(log_dir)`: a context manager that records torch.profiler's CPU
    and CUDA activity over its body and writes a Chrome trace file into
    log_dir (TensorBoard's and Perfetto's format);
  * `StepTimer`: rolling wall time and tokens/s over the last `window`
    steps, the JAX class's accounting;
  * `measure_dispatch_rtt(reps, device)`: the median wall time of one tiny
    op and a host read of its result, the floor a host-synchronised call
    pays.

The JAX module's `start_profiler_server(port)` starts jax.profiler's gRPC
endpoint, from which TensorBoard captures a live job; PyTorch has no such
server, and the port has no counterpart (ROADMAP lists it beside
utils/compile_cache.py as TPU-only).
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time

import torch

from starvector_tpu_torch import require_device


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the body with torch.profiler (CPU activity, and CUDA where a
    card is visible) and write `trace_<pid>_<ns>.json` into log_dir; yields
    the profiler (its key_averages() for a table)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class StepTimer:
    """`with timer:` around each step; avg_s is the mean wall time of the
    last `window` steps."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times: list[float] = []
        self._t0: float | None = None

    def __enter__(self):
        self._t0 = time.time()
        return self

    def __exit__(self, *exc):
        self.times.append(time.time() - self._t0)
        if len(self.times) > self.window:
            self.times.pop(0)

    @property
    def avg_s(self) -> float:
        return sum(self.times) / max(len(self.times), 1)

    def tokens_per_sec(self, tokens_per_step: int) -> float:
        return tokens_per_step / max(self.avg_s, 1e-9)


def measure_dispatch_rtt(reps: int = 20, device="cuda") -> float:
    """Median wall seconds of one tiny op on `device` (the card unless the
    caller asks for the CPU) and a host read of its result, after one
    untimed call."""
    device = require_device(device, 'device="cpu"')
    x = torch.zeros((8,), dtype=torch.int32, device=device)
    (x + 1).cpu()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        (x + 1).cpu()
        times.append(time.perf_counter() - t0)
    return float(statistics.median(times))
