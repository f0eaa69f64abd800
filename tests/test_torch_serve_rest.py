"""The port's serving REST stack on the CPU (starvector_tpu_torch/serve/
worker.py and controller.py, on the standard library), mirroring
tests/test_serve_rest.py: the controller's registry and dispatch; the
worker over loopback HTTP (b'{json}\\0' stream framing whose last text
equals the port API's greedy text for the same image, /worker_get_status,
/v1/chat/completions plain and SSE, the speculative route); four
concurrent streams through the port's controller; and the JAX package's
aiohttp controller dispatching to the port's worker unchanged. Every wait
has a timeout.
"""

import asyncio
import base64
import concurrent.futures
import io
import json
import threading

import numpy as np
import pytest
import torch

from starvector_tpu_torch.api import StarVectorForCausalLM
from starvector_tpu_torch.models import starvector as tsv
from starvector_tpu_torch.models.tokenizer import build_test_tokenizer
from starvector_tpu_torch.serve.controller import Controller
from starvector_tpu_torch.serve.controller import build_server as build_controller
from starvector_tpu_torch.serve.httpd import post_json, post_json_reply
from starvector_tpu_torch.serve.worker import (
    ModelWorker, build_server as build_worker, render_chat_template, serve_kwargs_from_leaf,
)

WAIT = 120


@pytest.fixture(scope="module")
def model():
    return StarVectorForCausalLM.from_config(tsv.tiny_config(), seed=0,
                                             tokenizer=build_test_tokenizer("v1"), device="cpu")


class Running:
    """A server (worker or controller) on 127.0.0.1 in a thread."""

    def __init__(self, server):
        self.server = server
        self.url = f"http://127.0.0.1:{server.server_address[1]}"
        self.thread = threading.Thread(target=server.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=WAIT)
        assert not self.thread.is_alive()


def image_b64(rgb) -> str:
    from PIL import Image

    buf = io.BytesIO()
    Image.new("RGB", (28, 28), rgb).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def stream(url: str, payload: dict) -> list[dict]:
    with post_json(url, payload, WAIT) as resp:
        raw = resp.read()
    return [json.loads(c) for c in raw.split(b"\0") if c]


def test_controller_dispatch_and_expiry():
    c = Controller("shortest_queue")
    assert c.get_worker_address("m") == ""
    c.register_worker("http://w1", True, {"model_names": ["m"], "speed": 1.0, "queue_length": 5})
    c.register_worker("http://w2", True, {"model_names": ["m"], "speed": 1.0, "queue_length": 0})
    assert c.get_worker_address("m") == "http://w2"
    assert c.worker_info["http://w2"].queue_length == 1  # dispatch counts the request
    assert c.list_models() == ["m"]
    assert c.receive_heart_beat("http://w1", 2) and not c.receive_heart_beat("http://w9", 0)
    c.worker_info["http://w1"].last_heart_beat = 0
    c.remove_stale_workers()
    assert list(c.worker_info) == ["http://w2"]
    with pytest.raises(ValueError):
        Controller("round_robin")


def test_controller_lottery_respects_models_and_speed():
    c = Controller("lottery")
    c.register_worker("http://a", True, {"model_names": ["x"], "speed": 1.0, "queue_length": 0})
    c.register_worker("http://b", True, {"model_names": ["x"], "speed": 0.0, "queue_length": 0})
    np.random.seed(0)
    assert {c.get_worker_address("x") for _ in range(20)} == {"http://a"}
    assert c.get_worker_address("y") == ""


def test_worker_stream_status_and_speculative_route(model):
    """/worker_generate_stream streams one \\0-framed chunk a token, its
    text growing from the '<svg' prompt to the port API's greedy text for
    the same image; /worker_get_status reports the engine; the
    speculative route gives the same text in one chunk."""
    worker = ModelWorker(model, worker_addr="http://t", max_batch=2, max_len=64)
    srv = Running(build_worker(worker))
    try:
        img = image_b64((250, 30, 30))
        payload = {"task": "im2svg", "image": img, "max_new_tokens": 5, "temperature": 0.0}
        chunks = stream(srv.url + "/worker_generate_stream", payload)
        spec = stream(srv.url + "/worker_generate_stream", {**payload, "use_speculative": True})
        status = post_json_reply(srv.url + "/worker_get_status", {}, WAIT)
    finally:
        srv.close()
        worker.shutdown()
    from PIL import Image

    pil = Image.open(io.BytesIO(base64.b64decode(img)))
    ref = model.generate_im2svg({"image": model.process_images([pil])}, max_length=5,
                                use_nucleus_sampling=False)[0]
    assert len(chunks) == 5 and all(c["error_code"] == 0 for c in chunks)
    lens = [len(c["text"]) for c in chunks]
    assert lens == sorted(lens) and chunks[0]["text"].startswith("<svg")
    assert chunks[-1]["text"] == ref
    assert [c["text"] for c in spec] == [ref] and spec[0]["error_code"] == 0
    assert status["model_names"] == ["starvector"] and status["engine"]["tokens_emitted"] == 5


def test_openai_chat_completions(model):
    """/v1/chat/completions with an image part: the plain reply and the SSE
    stream (deltas joining to the same text, then [DONE])."""
    worker = ModelWorker(model, worker_addr="oai", max_batch=2, max_len=64)
    srv = Running(build_worker(worker))
    body = {"model": "starvector", "max_tokens": 4, "temperature": 0.0,
            "messages": [{"role": "user", "content": [
                {"type": "text", "text": "<image-start>"},
                {"type": "image_url",
                 "image_url": {"url": f"data:image/png;base64,{image_b64((123, 40, 200))}"}}]}]}
    try:
        full = post_json_reply(srv.url + "/v1/chat/completions", body, WAIT)
        with post_json(srv.url + "/v1/chat/completions", {**body, "stream": True}, WAIT) as r:
            raw = r.read()
    finally:
        srv.close()
        worker.shutdown()
    assert full["object"] == "chat.completion" and full["usage"]["completion_tokens"] == 4
    content = full["choices"][0]["message"]["content"]
    assert content.startswith("<svg")
    lines = [line for line in raw.split(b"\n\n") if line.startswith(b"data: ")]
    assert lines[-1] == b"data: [DONE]"
    chunks = [json.loads(line[6:]) for line in lines[:-1]]
    assert all(c["object"] == "chat.completion.chunk" for c in chunks)
    assert "".join(c["choices"][0]["delta"]["content"] for c in chunks) == content


def test_port_controller_relays_concurrent_streams(model):
    """A worker registered with the port's controller; four concurrent
    streamed requests (greedy, sampled, a beam group, text2svg) through the
    controller's relay all finish without an error chunk, and the greedy
    one's text equals the worker's own."""
    controller = Controller("shortest_queue")
    worker = ModelWorker(model, worker_addr="placeholder", max_batch=4, max_len=64)
    wsrv, csrv = Running(build_worker(worker)), Running(build_controller(controller))
    try:
        worker.worker_addr, worker.controller_addr = wsrv.url, csrv.url
        worker.register()
        assert post_json_reply(csrv.url + "/list_models", {}, WAIT)["models"] == ["starvector"]
        assert post_json_reply(csrv.url + "/get_worker_address", {"model": "starvector"},
                               WAIT)["address"] == wsrv.url
        base = {"model": "starvector", "task": "im2svg", "image": image_b64((10, 200, 10)),
                "max_new_tokens": 4, "temperature": 0.0}
        payloads = [base, {**base, "temperature": 0.9}, {**base, "num_beams": 2},
                    {"model": "starvector", "task": "text2svg", "prompt": "a dot",
                     "max_new_tokens": 4, "temperature": 0.0}]
        with concurrent.futures.ThreadPoolExecutor(4) as ex:
            futs = [ex.submit(stream, csrv.url + "/worker_generate_stream", p) for p in payloads]
            outs = [f.result(timeout=WAIT) for f in futs]
        direct = stream(wsrv.url + "/worker_generate_stream", base)
        missing = post_json_reply(csrv.url + "/worker_generate_stream", {"model": "other"}, WAIT)
    finally:
        csrv.close()
        wsrv.close()
        worker.shutdown()
    for chunks in outs:
        assert chunks and all(c["error_code"] == 0 for c in chunks), chunks
        assert chunks[-1]["text"].startswith("<svg") or chunks is outs[3]
    assert outs[0][-1]["text"] == direct[-1]["text"]
    assert missing == {"text": "", "error_code": 2}


def test_jax_controller_dispatches_to_the_port_worker(model):
    """The JAX package's aiohttp controller registers the port's worker and
    relays a streamed request to it unchanged."""
    from aiohttp import ClientSession
    from aiohttp.test_utils import TestServer

    from starvector_tpu.serve.controller import Controller as JController
    from starvector_tpu.serve.controller import build_app as build_jax_controller

    worker = ModelWorker(model, worker_addr="placeholder", max_batch=2, max_len=64)
    wsrv = Running(build_worker(worker))

    async def scenario():
        csrv = TestServer(build_jax_controller(JController("shortest_queue")))
        await csrv.start_server()
        try:
            async with ClientSession() as session:
                async with session.post(csrv.make_url("/register_worker"), json={
                        "worker_name": wsrv.url, "check_heart_beat": True,
                        "worker_status": worker.get_status()}) as r:
                    assert (await r.json())["exist"]
                async with session.post(csrv.make_url("/worker_generate_stream"), json={
                        "model": "starvector", "task": "im2svg",
                        "image": image_b64((10, 200, 10)), "max_new_tokens": 3,
                        "temperature": 0.0}) as resp:
                    raw = await resp.read()
            return [json.loads(c) for c in raw.split(b"\0") if c]
        finally:
            await csrv.close()

    try:
        chunks = asyncio.new_event_loop().run_until_complete(
            asyncio.wait_for(scenario(), WAIT))
    finally:
        wsrv.close()
        worker.shutdown()
    assert len(chunks) == 3 and all(c["error_code"] == 0 for c in chunks)
    assert chunks[-1]["text"].startswith("<svg")


def test_render_chat_template_and_serve_config(tmp_path):
    msgs = [{"content": "a circle"}, {"content": " in red"}]
    assert render_chat_template(msgs) == "a circle in red"
    custom = tmp_path / "t.jinja"
    custom.write_text("{% for message in messages %}[{{ message.content }}]{% endfor %}")
    assert render_chat_template(msgs, template_path=str(custom)) == "[a circle][ in red]"
    assert render_chat_template(msgs, template_path=str(tmp_path / "absent")) == "a circle in red"
    broken = tmp_path / "broken.jinja"
    broken.write_text("{% for m in %}")
    assert render_chat_template(msgs, template_path=str(broken)) == "a circle in red"

    from starvector_tpu_torch.config import load_yaml

    kw = serve_kwargs_from_leaf(load_yaml("configs/generation/serve/starvector-1b/im2svg.yaml"))
    assert kw["max_batch"] >= 1 and kw["kv_cache_dtype"] in (None, torch.int8)
    assert serve_kwargs_from_leaf({"serve": {"kv_cache_dtype": "int8", "max_batch": 4}}) == {
        "mesh_axes": {}, "max_batch": 4, "max_len": 8192, "kv_cache_dtype": torch.int8,
        "hbm_proof_case": None}
    assert serve_kwargs_from_leaf(load_yaml("configs/generation/serve/starvector-8b/"
                                            "im2svg-tp4dp2.yaml")) == {
        "mesh_axes": {"tensor": 4, "data": 2}, "max_batch": 64, "max_len": 8192,
        "kv_cache_dtype": None, "hbm_proof_case": "serve_decode/tp4xdp2"}
