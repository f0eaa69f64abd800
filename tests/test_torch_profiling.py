"""utils/profiling.py against the JAX package's: StepTimer's window and
averages over the same mocked clock, a torch.profiler trace written on the
CPU, and the dispatch round trip on the CPU."""

import time

import pytest


@pytest.mark.parametrize("window", [1, 5, 50])
def test_step_timer_matches_jax(window, monkeypatch):
    """Both packages' StepTimer, stepped over one mocked clock (steps of
    1, 2, ..., 60 seconds), keep the same window of times and give the
    same mean and tokens/s after every step."""
    from starvector_tpu.utils import profiling as jprof
    from starvector_tpu_torch.utils import profiling as tprof

    clock = [0.0]
    monkeypatch.setattr(time, "time", lambda: clock[0])
    timers = [jprof.StepTimer(window), tprof.StepTimer(window)]
    assert timers[0].avg_s == timers[1].avg_s == 0.0
    for step in range(1, 61):
        for timer in timers:
            with timer:
                clock[0] += step
        assert timers[0].times == timers[1].times
        assert len(timers[1].times) == min(step, window)
        assert timers[0].avg_s == timers[1].avg_s
        assert timers[0].tokens_per_sec(4096) == timers[1].tokens_per_sec(4096)


def test_trace_writes_a_trace_file_on_the_cpu(tmp_path):
    """trace(log_dir) profiles its body and writes one Chrome trace (JSON
    with traceEvents) into the directory it makes."""
    import json

    import torch

    from starvector_tpu_torch.utils.profiling import trace

    with trace(str(tmp_path / "traces")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = list((tmp_path / "traces").glob("trace_*.json"))
    assert len(files) == 1 and prof.key_averages()
    assert json.loads(files[0].read_text())["traceEvents"]


def test_dispatch_rtt_on_the_cpu():
    """measure_dispatch_rtt(device="cpu") is a positive float number of
    seconds."""
    from starvector_tpu_torch.utils.profiling import measure_dispatch_rtt

    rtt = measure_dispatch_rtt(reps=5, device="cpu")
    assert isinstance(rtt, float) and 0.0 < rtt < 1.0
