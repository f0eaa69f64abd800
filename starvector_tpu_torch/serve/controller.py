"""Controller: worker registry, dispatch and heartbeat expiry (port of
starvector_tpu/serve/controller.py).

The reference controller (reference: starvector/serve/controller.py) on
the standard library's HTTP server, with the JAX controller's routes and
payloads:
  REST: /register_worker /refresh_all_workers /list_models
        /get_worker_address /receive_heart_beat /worker_generate_stream
        (relayed to a worker as it streams)
  Dispatch: "lottery" (speed-weighted random, :118-140) or
  "shortest_queue" (:142-169). Workers expire after
  CONTROLLER_HEART_BEAT_EXPIRATION seconds without a heartbeat
  (:49-52, 181-189).

Run beside the workers on the card's host:
    python -m starvector_tpu_torch.serve.controller --port 21001
(`--device cpu` on a host without a card.)
"""

from __future__ import annotations

import argparse
import dataclasses
import threading
import time

import numpy as np

from starvector_tpu_torch import require_device
from starvector_tpu_torch.serve.constants import (
    CONTROLLER_HEART_BEAT_EXPIRATION, WORKER_API_TIMEOUT,
)
from starvector_tpu_torch.serve.httpd import make_server, post_json


@dataclasses.dataclass
class WorkerInfo:
    model_names: list[str]
    speed: float
    queue_length: int
    check_heart_beat: bool
    last_heart_beat: float


class Controller:
    def __init__(self, dispatch_method: str = "shortest_queue"):
        if dispatch_method not in ("lottery", "shortest_queue"):
            raise ValueError(f"dispatch_method {dispatch_method!r}: lottery | shortest_queue")
        self.dispatch_method = dispatch_method
        self.worker_info: dict[str, WorkerInfo] = {}
        # the server's threads share the registry
        self._lock = threading.Lock()

    # -- registry --------------------------------------------------------------
    def register_worker(self, worker_name: str, check_heart_beat: bool,
                        worker_status: dict | None) -> bool:
        if worker_status is None:
            return False
        with self._lock:
            self.worker_info[worker_name] = WorkerInfo(
                model_names=worker_status["model_names"],
                speed=worker_status.get("speed", 1.0),
                queue_length=worker_status.get("queue_length", 0),
                check_heart_beat=check_heart_beat, last_heart_beat=time.time())
        print(f"Register worker: {worker_name}")
        return True

    def receive_heart_beat(self, worker_name: str, queue_length: int) -> bool:
        with self._lock:
            info = self.worker_info.get(worker_name)
            if info is None:
                return False
            info.queue_length = queue_length
            info.last_heart_beat = time.time()
            return True

    def remove_stale_workers(self):
        expire = time.time() - CONTROLLER_HEART_BEAT_EXPIRATION
        with self._lock:
            for name in [n for n, i in self.worker_info.items()
                         if i.check_heart_beat and i.last_heart_beat < expire]:
                print(f"Remove stale worker: {name}")
                del self.worker_info[name]

    def list_models(self) -> list[str]:
        with self._lock:
            return sorted({m for info in self.worker_info.values() for m in info.model_names})

    # -- dispatch (reference :118-169) -----------------------------------------
    def get_worker_address(self, model_name: str) -> str:
        with self._lock:
            candidates = [(n, i) for n, i in self.worker_info.items() if model_name in i.model_names]
            if not candidates:
                return ""
            if self.dispatch_method == "lottery":
                speeds = np.array([i.speed for _, i in candidates], np.float32)
                total = float(speeds.sum())
                if total <= 0:
                    return ""
                idx = int(np.searchsorted(np.cumsum(speeds), np.random.uniform(0, total)))
                return candidates[min(idx, len(candidates) - 1)][0]
            # shortest_queue, normalized by speed
            idx = int(np.argmin([i.queue_length / max(i.speed, 1e-6) for _, i in candidates]))
            name, info = candidates[idx]
            info.queue_length += 1
            return name

    def expire_loop(self, stop: threading.Event) -> None:
        """Remove stale workers every CONTROLLER_HEART_BEAT_EXPIRATION s
        until `stop` is set."""
        while not stop.wait(CONTROLLER_HEART_BEAT_EXPIRATION):
            self.remove_stale_workers()


def build_server(controller: Controller, host: str = "127.0.0.1", port: int = 0):
    """The controller's HTTP server (httpd.make_server) with its routes."""

    def register_worker(h, data):
        h.send_json({"exist": controller.register_worker(
            data["worker_name"], data["check_heart_beat"], data.get("worker_status"))})

    def refresh_all_workers(h, data):
        controller.remove_stale_workers()
        h.send_json({})

    def list_models(h, data):
        h.send_json({"models": controller.list_models()})

    def get_worker_address(h, data):
        h.send_json({"address": controller.get_worker_address(data["model"])})

    def receive_heart_beat(h, data):
        h.send_json({"exist": controller.receive_heart_beat(data["worker_name"],
                                                            data["queue_length"])})

    def worker_generate_stream(h, data):
        """Relay to the chosen worker, chunk by chunk (reference :237-281)."""
        addr = controller.get_worker_address(data.get("model", ""))
        if not addr:
            h.send_json({"text": "", "error_code": 2})
            return
        with post_json(addr + "/worker_generate_stream", data, WORKER_API_TIMEOUT) as upstream:
            h.start_stream()
            while chunk := upstream.read1(65536):
                h.write_chunk(chunk)

    return make_server(host, port, {
        "/register_worker": register_worker, "/refresh_all_workers": refresh_all_workers,
        "/list_models": list_models, "/get_worker_address": get_worker_address,
        "/receive_heart_beat": receive_heart_beat,
        "/worker_generate_stream": worker_generate_stream})


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=21001)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default): the host of the card the workers serve on; cpu")
    parser.add_argument("--dispatch-method", default="shortest_queue",
                        choices=["lottery", "shortest_queue"])
    args = parser.parse_args(argv)
    require_device(args.device, "--device cpu")
    controller = Controller(args.dispatch_method)
    stop = threading.Event()
    threading.Thread(target=controller.expire_loop, args=(stop,), daemon=True).start()
    server = build_server(controller, args.host, args.port)
    try:
        server.serve_forever()
    finally:
        stop.set()
        server.server_close()


if __name__ == "__main__":
    main()
