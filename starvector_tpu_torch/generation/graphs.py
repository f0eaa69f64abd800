"""CUDA graphs of decode steps: the port's counterpart of the JAX package's
jitted decode loops (the `lax.while_loop` of generate,
starvector_tpu/generation/engine.py:225, and the serving tick's `lax.scan`,
starvector_tpu/serve/engine.py:357), which run as one device program with
no host round trip a token.

A `StepGraph` captures static decode steps (one of generate's, the
decoders' `forward_decode_static`; a pipelined stream's fused or
decode-only step; a speculative round; or the serving engine's static
tick: every loop-varying scalar on the device, every buffer allocated
before the capture) once and replays it. A `StepLoop` runs one loop's
steps by kind: the first of each kind as the warm-up, then one graph a
(kind, key) captured at its first step and replayed for every later one;
the loop reads the device once a block of steps (`host_read`). Capture
and warm-up run on one side stream per device, both under `CAPTURE_LOCK`,
so that the libraries' lazy set-up (cuBLAS's workspace for that stream,
the kernels' scratch) happens before a capture, never inside one. A graph
holds the kernels' scratch buffers it launched with, which a later, larger
launch replaces: they are freed only with the graph. A capture that fails
raises; nothing falls back to the eager loop.

Launch counts. A kernel wrapper counts a launch where it launches its
kernel: inside a capture it runs once and adds one, but nothing is
launched then, and a replay launches every captured kernel again without
running a wrapper. So each graph records the wrappers' counts its capture
added (`StepGraph.launches`), and the module's tally keeps what captures
added and what replays launched: a run's launches are the wrappers' counts
minus `tally()["captured"]` plus `tally()["replayed"]` (`true_launches`).
A capture holds `CAPTURE_LOCK`, and so does other counted device work that
may run beside it on another thread (the serving engine's admission
prefill), so that a graph's counts are its own steps' alone.

The key bounds' buckets (`bucket_len`) are powers of two, as the serving
engine's prompt buckets: a graph whose split grid is planned at a bucket
reads no more keys than twice the longest row holds.
"""

from __future__ import annotations

import collections
import threading
import time

import torch


def bucket_len(n: int, lo: int = 64) -> int:
    """n rounded up to a power of two, at least lo."""
    b = lo
    while b < n:
        b *= 2
    return b


def launch_counts() -> dict[str, int]:
    """Every kernel wrapper's launch count: the attention kernels, the
    int8-cache share of decode_attention, quant_matmul in all and by path."""
    from starvector_tpu_torch.ops import flash_attention as tfa
    from starvector_tpu_torch.ops import quantization as tq

    counts = {name: getattr(tfa, name).launches
              for name in ("flash_prefill", "decode_attention", "flash_prefill_with_lse",
                           "flash_bwd_dkdv", "flash_bwd_dq")}
    counts["decode_attention_int8"] = tfa.decode_attention.int8_launches
    counts["quant_matmul"] = tq.quant_matmul.launches
    counts.update({f"quant_matmul_{k}": v for k, v in tq.quant_matmul.path_launches.items()})
    return counts


# held by a capture, and by counted device work of another thread that may
# run beside one
CAPTURE_LOCK = threading.RLock()

_TALLY = {"captured": collections.Counter(), "replayed": collections.Counter(),
          "captures": 0, "replays": 0, "capture_s": 0.0}


def reset_tally() -> None:
    """Zero the tally (with the wrappers' counts, before a counted run)."""
    _TALLY["captured"].clear()
    _TALLY["replayed"].clear()
    _TALLY["captures"] = _TALLY["replays"] = 0
    _TALLY["capture_s"] = 0.0


def tally() -> dict:
    """{"captured": launches the captures counted, "replayed": launches the
    replays made (each a Counter by launch_counts' names), "captures",
    "replays", "capture_s": host seconds spent capturing} since the last
    reset_tally."""
    return {"captured": collections.Counter(_TALLY["captured"]),
            "replayed": collections.Counter(_TALLY["replayed"]),
            "captures": _TALLY["captures"], "replays": _TALLY["replays"],
            "capture_s": _TALLY["capture_s"]}


def true_launches(counts: dict[str, int]) -> dict[str, int]:
    """The kernels a run launched, from the wrappers' counts over it (taken
    after reset_tally): minus what its captures counted, plus what its
    replays launched."""
    t = tally()
    return {k: v - t["captured"][k] + t["replayed"][k] for k, v in counts.items()}


def reserve_decode(device: torch.device, llm_cfg, B: int, t_cap: int) -> None:
    """Grow kernel 2's scratch for B rows of the decoder `llm_cfg` (a
    GPTBigCode or StarCoder2 config) over t_cap keys, before a capture of
    steps that launch it so: inside a capture the scratch cannot grow."""
    from starvector_tpu_torch.ops import flash_attention as tfa

    H = getattr(llm_cfg, "n_head", None) or llm_cfg.num_attention_heads
    Hkv = llm_cfg.kv_heads
    tfa.reserve_decode_scratch(device, B, Hkv, H // Hkv, llm_cfg.head_dim, t_cap)


_STREAMS: dict[torch.device, torch.cuda.Stream] = {}


def side_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream every capture and warm-up on `device` runs on."""
    device = torch.device(device)
    if device not in _STREAMS:
        _STREAMS[device] = torch.cuda.Stream(device=device)
    return _STREAMS[device]


def on_side_stream(device: torch.device, fn):
    """fn() on the side stream, ordered after the work queued on the current
    stream and before the work queued on it later (a warm-up step that
    must run where the captures will). Holds CAPTURE_LOCK, as a capture
    does: the stream is the process's, and another thread's capture on it
    would record fn's launches into its graph."""
    with CAPTURE_LOCK:
        stream, cur = side_stream(device), torch.cuda.current_stream(device)
        stream.wait_stream(cur)
        with torch.cuda.stream(stream):
            out = fn()
        cur.wait_stream(stream)
    return out


def kernel_scratch() -> list[torch.Tensor]:
    """The kernels' cached scratch buffers, on every device: kernel 2's
    tickets and split partials, kernel 14's GEMV's. A launch passes them to
    its kernel as raw addresses; a buffer that outgrows them replaces them
    and frees the old ones."""
    from starvector_tpu_torch.ops import flash_attention as tfa
    from starvector_tpu_torch.ops import quantization as tq

    return [t for cached in (tfa._DECODE_SCRATCH, tq._GEMV_SCRATCH)
            for pair in cached.values() for t in pair]


class StepGraph:
    """`fn` (static decode steps: in-place writes to buffers made before the
    capture) captured once as a CUDA graph on `device`, in the memory pool
    `pool` (a torch.cuda.graph_pool_handle shared by graphs that never run
    at once), with the random state of each of `generators` registered, so
    that every replay draws fresh numbers from them as the eager steps
    would. Raises where the capture fails. The graph holds the kernels'
    scratch buffers as they were at its capture (kernel_scratch): its
    launches keep their addresses, so the buffers live while it does, and
    a replay after the scratch grew writes only into its own."""

    def __init__(self, fn, device: torch.device, *, pool=None, generators=()):
        device = torch.device(device)
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        for gen in generators:
            if gen is not None:
                self.graph.register_generator_state(gen)
        stream, cur = side_stream(device), torch.cuda.current_stream(device)
        with CAPTURE_LOCK:
            before = launch_counts()
            stream.wait_stream(cur)
            with torch.cuda.stream(stream):
                # thread_local: another thread's uncounted work (the serving
                # engine's admissions) is not refused meanwhile
                self.graph.capture_begin(pool=pool, capture_error_mode="thread_local")
                try:
                    fn()
                except BaseException:
                    try:
                        self.graph.capture_end()
                    except RuntimeError:
                        pass  # the capture is invalid already: report fn's error
                    raise
                self.graph.capture_end()
            cur.wait_stream(stream)
            after = launch_counts()
        self.scratch = kernel_scratch()
        self.launches = collections.Counter(
            {k: v - before[k] for k, v in after.items() if v != before[k]})
        self.replays = 0
        _TALLY["captured"].update(self.launches)
        _TALLY["captures"] += 1
        _TALLY["capture_s"] += time.perf_counter() - t0

    def replay(self) -> None:
        self.graph.replay()
        self.replays += 1
        _TALLY["replayed"].update(self.launches)
        _TALLY["replays"] += 1


class StepLoop:
    """The static steps of one decode loop (generation/engine.py,
    generation/speculative.py), by kind. On the card with `enabled`, the
    first step of each kind runs uncaptured on the side stream, as the
    warm-up (the libraries' lazy set-up, the kernels' scratch), and its
    (kind, key) is captured right after it; every later step replays the
    StepGraph of its (kind, key), captured at the first step that meets
    it. So a key is captured in the first batch of a stream that meets it,
    and a longer stream of the same batches captures nothing more. The
    graphs share one pool (they never run at once; a step's buffers are
    made before its capture and written in place). Otherwise every step
    runs uncaptured, with the same launches. `fn` must be a step whose
    launches depend on its key alone."""

    def __init__(self, device, enabled: bool, generators=()):
        self.device = torch.device(device)
        self.enabled = enabled and self.device.type == "cuda"
        self.generators = generators
        self.graphs: dict = {}
        self.warmed: set = set()
        self.pool = torch.cuda.graph_pool_handle() if self.enabled else None

    def run(self, kind: str, key, fn) -> None:
        if not self.enabled:
            fn()
            return
        warm_up = kind not in self.warmed
        if warm_up:
            self.warmed.add(kind)
            on_side_stream(self.device, fn)
        graph = self.graphs.get((kind, key))
        if graph is None:
            graph = self.graphs[(kind, key)] = StepGraph(
                fn, self.device, pool=self.pool, generators=self.generators)
        if not warm_up:
            graph.replay()

    @property
    def captures(self) -> int:
        return len(self.graphs)


def host_read(*scalars: torch.Tensor) -> list[int]:
    """The loops' one host read a block: one-element device tensors (a
    `done.all()`, a length) as ints, in one transfer."""
    return torch.stack([x.reshape(()).long() for x in scalars]).tolist()
