"""The port's web UI (starvector_tpu_torch/serve/webui.py, on the standard
library) held to tests/test_webui.py's cases through urllib: the page
serves and equals the JAX package's; /api/generate streams a port
ModelWorker's b'{json}\\0' chunks (a tiny model, 3 greedy tokens) through
unchanged; a vote lands in votes.jsonl. Then the port's
serve/conversation.py against the JAX module on the same inputs:
conversation state, image modes and close_svg. Every wait has a timeout."""

import base64
import io
import json
import threading
import urllib.request

import pytest

from starvector_tpu.serve import conversation as jconv
from starvector_tpu.serve import webui as jwebui
from starvector_tpu_torch.api import StarVectorForCausalLM
from starvector_tpu_torch.models import starvector as tsv
from starvector_tpu_torch.models.tokenizer import build_test_tokenizer
from starvector_tpu_torch.serve import conversation as tconv
from starvector_tpu_torch.serve import webui
from starvector_tpu_torch.serve.httpd import post_json
from starvector_tpu_torch.serve.worker import ModelWorker, build_server as build_worker

WAIT = 120


class Running:
    """A server on 127.0.0.1 in a thread."""

    def __init__(self, server):
        self.server = server
        self.url = f"http://127.0.0.1:{server.server_address[1]}"
        self.thread = threading.Thread(target=server.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=WAIT)


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """A port worker on a tiny fp32 model behind the port's web UI."""
    log_dir = tmp_path_factory.mktemp("webui")
    model = StarVectorForCausalLM.from_config(tsv.tiny_config(), seed=0,
                                              tokenizer=build_test_tokenizer("v1"), device="cpu")
    worker = ModelWorker(model, worker_addr="x", max_batch=2, max_len=64)
    w = Running(build_worker(worker))
    ui = Running(webui.build_server(w.url, str(log_dir)))
    yield w, ui, log_dir
    ui.close()
    w.close()
    worker.shutdown()


def png_b64(rgb) -> str:
    from PIL import Image

    buf = io.BytesIO()
    Image.new("RGB", (28, 28), rgb).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def test_page_serves(servers):
    _, ui, _ = servers
    with urllib.request.urlopen(ui.url + "/", timeout=WAIT) as r:
        assert r.status == 200 and r.headers["Content-Type"].startswith("text/html")
        page = r.read().decode()
    assert "StarVector" in page and "api/generate" in page
    assert page == jwebui.INDEX_HTML


def test_generate_streams_the_workers_chunks(servers):
    """3 greedy tokens: 3 chunks, each the prompt and the tokens so far;
    the same bytes as the worker's own stream for the same payload."""
    w, ui, _ = servers
    payload = {"task": "im2svg", "image": png_b64((9, 9, 200)), "max_new_tokens": 3,
               "temperature": 0.0}
    with post_json(ui.url + "/api/generate", payload, WAIT) as r:
        raw = r.read()
    chunks = [json.loads(c) for c in raw.split(b"\0") if c]
    assert len(chunks) == 3
    assert all(c["error_code"] == 0 and c["text"].startswith("<svg") for c in chunks)
    with post_json(w.url + "/worker_generate_stream", payload, WAIT) as r:
        assert r.read() == raw


def test_vote_is_logged(servers):
    _, ui, log_dir = servers
    with post_json(ui.url + "/api/vote", {"vote": 1, "svg": "<svg/>"}, WAIT) as r:
        assert r.status == 200 and json.loads(r.read()) == {}
    records = [json.loads(line) for line in open(log_dir / "votes.jsonl")]
    assert records[-1]["vote"] == 1 and records[-1]["svg"] == "<svg/>" and "ts" in records[-1]


@pytest.mark.parametrize("mod", [jconv, tconv], ids=["jax", "port"])
def test_conversation_state(mod):
    conv = mod.Conversation()
    conv.append_message("user", "make an svg", image="IMG")
    conv.append_message("assistant", "<svg/>")
    assert conv.get_prompt() == "<svg"
    assert conv.get_images() == ["IMG"]
    c2 = conv.copy()
    c2.messages.clear()
    assert len(conv.messages) == 2
    d = conv.dict()
    assert d["messages"][0]["role"] == "user" and "image" not in d["messages"][0]


def test_conversation_matches_jax():
    """The same messages give the same prompt, images and dict in both
    packages."""
    convs = [mod.Conversation() for mod in (jconv, tconv)]
    for conv in convs:
        conv.append_message("user", "a red circle", image="IMG")
        conv.append_message("assistant", "<svg><circle/></svg>")
    j, t = convs
    assert t.get_prompt() == j.get_prompt() and t.get_images() == j.get_images()
    assert t.dict() == j.dict()


def test_conversation_image_modes():
    """Pad and Resize on both packages: the same sizes and pixels."""
    import numpy as np
    from PIL import Image

    for mode, img, size in (("Pad", Image.new("RGB", (40, 20), (0, 0, 0)), (40, 40)),
                            ("Resize", Image.new("RGBA", (40, 20), (0, 0, 0, 0)), (336, 336))):
        out = tconv.Conversation(image_process_mode=mode).process_image(img)
        ref = jconv.Conversation(image_process_mode=mode).process_image(img)
        assert out.size == ref.size == size
        np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


@pytest.mark.parametrize("svg", ["<svg><g><path d='M0 0'/>", "<svg></svg>", "<svg><g><rect/>"])
def test_close_svg(svg):
    assert tconv.close_svg(svg) == jconv.close_svg(svg)
    if svg == "<svg><g><path d='M0 0'/>":
        assert tconv.close_svg(svg) == "<svg><g><path d='M0 0'/></g></svg>"

