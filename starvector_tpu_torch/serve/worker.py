"""Model worker: loads the model, serves streaming generation, heartbeats
(port of starvector_tpu/serve/worker.py).

The reference worker (reference: starvector/serve/model_worker.py) on the
standard library's HTTP server and the port's continuous-batching
ServeEngine, with the JAX worker's routes, payloads and framing, so that
the JAX controller and web UI drive it unchanged:
  REST: /worker_generate_stream (b'{json}\\0' chunks, reference :174-181),
        /worker_get_status, /v1/chat/completions (OpenAI; SSE with stream)
  Registers with the controller and heartbeats every
  WORKER_HEART_BEAT_INTERVAL s (:31-34, 85-104); re-registers if forgotten.
  im2svg: base64 image -> processor -> visual prefix || '<svg' prompt
  (:120-181); text2svg: caption + <svg-start>.

Run on the card:
    python -m starvector_tpu_torch.serve.worker --model-path /ckpt --port 21002 \\
        --controller http://localhost:21001
(`--device cpu` runs it on the CPU.)

A serve config whose mesh sets any axis above 1 (the 8B's
im2svg-tp4dp2.yaml and im2svg-tp8-int8kv.yaml; a leaf of the same form for
the 1B, whose 16 query heads split over tensor 2, 4 or 8; or a leaf whose
mesh sets fsdp, sequence or stage, alone or beside data and tensor) runs
under torchrun, one process a card:
    python -m torch.distributed.run --nproc-per-node 8 \\
        -m starvector_tpu_torch.serve.worker --model-path /ckpt --port 21002 \\
        --controller http://localhost:21001 \\
        --serve-config configs/generation/serve/starvector-8b/im2svg-tp4dp2.yaml
Ranks are row-major over (replica, data, fsdp, sequence, stage, tensor).
The ranks of one data group (parallel/tensor.py::ServingGroup) serve one
engine: each reads its own shards of the decoder (its tensor slices, and
its stage block and fsdp shards of them as the JAX rules place them,
gathered at use in every cached forward); the group's first rank computes
the prefixes with the whole tower (and a whole token table), runs the
engine with max_batch / data slots and serves HTTP on --port + d,
registered with the controller, whose shortest-queue dispatch spreads
requests over the data groups; the other ranks of its group replay its
device calls (ServeEngine.follow) and serve no HTTP. With --quantize each
rank quantizes its own shards of the decoder
(api.StarVectorForCausalLM.from_pretrained), and `use_speculative`
requests run as one command of the group's engine.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import os
import queue
import threading

import numpy as np
import torch

from starvector_tpu_torch import require_device
from starvector_tpu_torch.serve.constants import WORKER_API_TIMEOUT, WORKER_HEART_BEAT_INTERVAL
from starvector_tpu_torch.serve.engine import Request, ServeEngine
from starvector_tpu_torch.serve.httpd import make_server, post_json_reply

_CHAT_TEMPLATE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                                   "configs", "chat-template.jinja")


def render_chat_template(messages, template_path: str | None = None) -> str:
    """Render text-only chat messages through the chat template
    (configs/chat-template.jinja: plain content concatenation). Image parts
    are the endpoint's. Without jinja2, or with a template file that is
    missing or malformed, the contents are concatenated."""
    path = template_path or os.environ.get("STARVECTOR_CHAT_TEMPLATE", _CHAT_TEMPLATE_PATH)
    texts = [m["content"] for m in messages if isinstance(m.get("content"), str)]
    try:
        import jinja2
    except ImportError:
        return "".join(texts)
    try:
        with open(path) as f:
            template = jinja2.Template(f.read())
        return template.render(messages=[{"content": t} for t in texts])
    except (OSError, jinja2.TemplateError):
        return "".join(texts)


def serve_kwargs_from_leaf(leaf) -> dict:
    """Map a serve config leaf's `serve:` block (configs/generation/serve/)
    onto engine and worker kwargs: the mesh axes ({axis: size}: any axis
    above 1 runs under torchrun, main; each data group of fsdp x sequence x
    stage x tensor ranks serves one engine, parallel/tensor.py::
    ServingGroup), max_batch / max_len, kv_cache_dtype ("int8" ->
    torch.int8, "bfloat16" or absent -> None: the compute dtype). A mesh
    axis the mesh does not have raises ValueError."""
    from starvector_tpu_torch.parallel.tensor import serving_mesh_config

    s = leaf.get("serve") or {}
    get = s.get_path if hasattr(s, "get_path") else lambda k, d=None: s.get(k, d)
    kv_raw = str(get("kv_cache_dtype", "bfloat16") or "bfloat16")
    if kv_raw not in ("bfloat16", "int8"):
        raise ValueError(f"serve.kv_cache_dtype={kv_raw!r}: expected bfloat16 | int8")
    mesh_axes = {k: int(v) for k, v in dict(s.get("mesh") or {}).items()}
    serving_mesh_config(mesh_axes)
    return {
        "mesh_axes": mesh_axes,
        "max_batch": int(get("max_batch", 8)),
        "max_len": int(get("max_len", 8192)),
        "kv_cache_dtype": torch.int8 if kv_raw == "int8" else None,
        "hbm_proof_case": get("hbm_proof_case"),
    }


class ModelWorker:
    def __init__(
        self,
        model,                      # api.StarVectorForCausalLM
        *,
        worker_addr: str,
        controller_addr: str | None = None,
        model_names: list[str] | None = None,
        limit_model_concurrency: int = 5,
        max_batch: int = 8,
        max_len: int = 8192,
        kv_cache_dtype=None,
        spec_drafts: int = 0,       # engine prompt-lookup speculation
        steps_per_tick: int = 4,
        group=None,                 # the leader's ServingGroup on a serving mesh
    ):
        self.model = model
        self.worker_addr = worker_addr
        self.controller_addr = controller_addr
        self.model_names = model_names or ["starvector"]
        self.limit = threading.Semaphore(limit_model_concurrency)
        self.group = group
        self.engine = make_engine(model, group=group, max_batch=max_batch, max_len=max_len,
                                  kv_cache_dtype=kv_cache_dtype, spec_drafts=spec_drafts,
                                  steps_per_tick=steps_per_tick)
        self.engine.start()
        self._hb_thread: threading.Thread | None = None
        self._stop = threading.Event()

    # -- request prep ----------------------------------------------------------
    @torch.inference_mode()
    def _prefix_for(self, payload: dict):
        """(prefix_embeds (1, P, E), prompt_text, ids_aligned (1, P) with -1
        over the visual tokens). Returned, not stored: requests run on
        concurrent threads."""
        from starvector_tpu_torch.generation.engine import im2svg_prefix

        tok = self.model.tokenizer
        device = self.model.device
        params = prefix_params(self.model.params)
        if payload.get("task", "im2svg") == "im2svg":
            from PIL import Image

            pil = Image.open(io.BytesIO(base64.b64decode(payload["image"])))
            images = self.model.process_images([pil])
            prompt = payload.get("prompt") or tok.prompt
            ids = torch.tensor(tok([prompt], add_special_tokens=False)["input_ids"],
                               device=device)
            prefix, _ = im2svg_prefix(params, self.model.cfg, images, ids,
                                      policy=self.model.policy)
            visual = prefix.shape[1] - ids.shape[1]
            ids_aligned = torch.cat([torch.full((1, visual), -1, dtype=ids.dtype, device=device),
                                     ids], dim=1)
            return prefix, prompt, ids_aligned
        text = payload.get("prompt", "") + tok.svg_start_token
        ids = torch.tensor(tok([text], add_special_tokens=False)["input_ids"], device=device)
        dec = self.model.cfg.decoder_module
        prefix = self.model.policy.cast(dec.embed_tokens(params["svg_transformer"], ids))
        return prefix, "", ids

    def make_request(self, payload: dict) -> tuple[Request, str]:
        prefix, prompt_text, ids_aligned = self._prefix_for(payload)
        tok = self.model.tokenizer
        # the real prompt ids (the visual positions dropped): the repetition
        # penalty's presence, HF/vLLM's prompt-and-output semantics
        ids = ids_aligned.reshape(-1).cpu().numpy()
        prompt_ids = ids[ids >= 0]
        logit_bias = payload.get("logit_bias") or None
        if logit_bias:
            logit_bias = {int(k): float(v) for k, v in logit_bias.items()}
        temperature = float(payload.get("temperature", 0.8))
        req = Request(
            prefix_embeds=prefix,
            max_new_tokens=int(payload.get("max_new_tokens", 512)),
            temperature=temperature,
            top_p=float(payload.get("top_p", 0.9)),
            top_k=int(payload.get("top_k", 0)),
            min_p=float(payload.get("min_p", 0.0)),
            repetition_penalty=float(payload.get("repetition_penalty", 1.0)),
            frequency_penalty=float(payload.get("frequency_penalty", 0.0)),
            presence_penalty=float(payload.get("presence_penalty", 0.0)),
            logit_bias=logit_bias,
            prompt_token_ids=prompt_ids if prompt_ids.size else None,
            do_sample=temperature > 0,
            stop_sequences=(tuple(tok.stop_sequence_ids("</svg>")),),
            eos_token_id=tok.eos_token_id,
            num_beams=int(payload.get("num_beams", 1)),
            length_penalty=float(payload.get("length_penalty", 1.0)),
        )
        return req, prompt_text

    @torch.inference_mode()
    def generate_speculative(self, payload: dict) -> str:
        """Prompt-lookup speculative decoding (greedy, one stream: the
        port's generate_greedy_speculative); the same tokens as greedy.
        Routed by `use_speculative` in the payload. On a serving group it
        runs through the engine (ServeEngine.generate_speculative), whose
        followers replay it on their slices."""
        from starvector_tpu_torch.generation.speculative import generate_greedy_speculative

        prefix, prompt_text, ids_aligned = self._prefix_for(payload)
        tok = self.model.tokenizer
        kw = dict(max_new_tokens=int(payload.get("max_new_tokens", 512)),
                  draft_len=int(payload.get("draft_len", 8)),
                  stop_sequences=(tuple(tok.stop_sequence_ids("</svg>")),),
                  eos_token_id=tok.eos_token_id, pad_token_id=tok.pad_token_id)
        if self.group is not None and self.group.size > 1:
            tokens, lengths, _ = self.engine.generate_speculative(prefix, ids_aligned, **kw)
        else:
            mask = torch.ones(prefix.shape[:2], dtype=torch.int32, device=prefix.device)
            tokens, lengths, _ = generate_greedy_speculative(
                self.model.params["svg_transformer"], self.model.cfg.llm, prefix, mask,
                ids_aligned, policy=self.model.policy, kernels=self.model.kernels, **kw)
        row = tokens[0, :int(lengths[0])].cpu().numpy()
        return prompt_text + tok.decode(row)

    def events(self, req: Request):
        """The request's engine events, ending with "done" or "error"; a gap
        of WORKER_API_TIMEOUT seconds between two ends it with an error."""
        while True:
            try:
                kind, data = req.out_queue.get(timeout=WORKER_API_TIMEOUT)
            except queue.Empty:
                yield "error", f"no engine event in {WORKER_API_TIMEOUT} s"
                return
            yield kind, data
            if kind != "token":
                return

    # -- heartbeat -------------------------------------------------------------
    def get_status(self) -> dict:
        return {"model_names": self.model_names, "speed": 1.0,
                "queue_length": self.engine.queue_length, "engine": self.engine.stats()}

    def start_heartbeat(self):
        if not self.controller_addr or self._hb_thread:
            return

        def loop():
            while not self._stop.is_set():
                try:
                    r = post_json_reply(self.controller_addr + "/receive_heart_beat",
                                        {"worker_name": self.worker_addr,
                                         "queue_length": self.engine.queue_length}, timeout=5)
                    if not r.get("exist", False):
                        self.register()
                except (OSError, ValueError) as e:  # unreachable controller, bad reply
                    print(f"heartbeat error: {e}")
                self._stop.wait(WORKER_HEART_BEAT_INTERVAL)

        self._hb_thread = threading.Thread(target=loop, daemon=True)
        self._hb_thread.start()

    def register(self):
        if not self.controller_addr:
            return
        post_json_reply(self.controller_addr + "/register_worker",
                        {"worker_name": self.worker_addr, "check_heart_beat": True,
                         "worker_status": self.get_status()}, timeout=10)

    def shutdown(self):
        self._stop.set()
        self.engine.stop()


def prefix_params(params: dict) -> dict:
    """The weights a request's prefix is made of: the tower, the adapter
    and the decoder's token table, whole. A serving group's leader holds
    them whole (models/starvector.py::serving_params: the table as
    `prompt_decoder` where the decoder's is split), so that no request
    thread gathers."""
    if "prompt_decoder" not in params:
        return params
    return {**params, "svg_transformer": params["prompt_decoder"]}


def make_engine(model, *, group=None, max_batch: int = 8, max_len: int = 8192,
                kv_cache_dtype=None, spec_drafts: int = 0, steps_per_tick: int = 4) -> ServeEngine:
    """The ServeEngine of `model`'s decoder, on its device; with a serving
    group (model being that rank's, starvector.serving_params or
    from_pretrained(group=)), the rank's part of the group's engine: the
    leader's, which the worker starts, or a follower's, which then runs
    `follow()`."""
    return ServeEngine(model.params["svg_transformer"], model.cfg.llm, model.cfg.decoder,
                       max_batch=max_batch, max_len=max_len, policy=model.policy,
                       kv_cache_dtype=kv_cache_dtype, spec_drafts=spec_drafts,
                       steps_per_tick=steps_per_tick, device=model.device, kernels=model.kernels,
                       group=group)


def serve_rank(model, group, *, data: int, port: int, host: str = "0.0.0.0",
               worker_address: str | None = None, controller: str | None = None,
               max_batch: int = 8, warmup: bool = False, limit_model_concurrency: int = 5,
               **engine_kw) -> None:
    """One rank of a serving mesh of `data` groups of `group.size` ranks:
    the leader of data group d serves a ModelWorker of max_batch / data
    slots on port + d (registered with the controller) until the process
    is stopped or its serving group falls out of step (then it raises, and
    torchrun stops the group); a follower replays its leader's device
    calls until the leader stops."""
    if max_batch % data:
        raise ValueError(f"max_batch {max_batch} does not split over {data} data groups")
    slots = max_batch // data
    if not group.is_leader:
        make_engine(model, group=group, max_batch=slots, **engine_kw).follow()
        return
    d = group.data_rank
    if worker_address is not None and data > 1:
        raise ValueError("--worker-address names one worker; a mesh with data > 1 serves one "
                         "on each of --port + d")
    worker = ModelWorker(model, worker_addr=worker_address or f"http://localhost:{port + d}",
                         controller_addr=controller, max_batch=slots, group=group,
                         limit_model_concurrency=limit_model_concurrency, **engine_kw)
    run_worker(worker, host, port + d, warmup)


def run_worker(worker: ModelWorker, host: str, port: int, warmup: bool = False) -> None:
    """Register with the controller, heartbeat and serve HTTP until the
    process is stopped; a serving group's leader also stops (raising) when
    its group falls out of step."""
    if warmup:
        worker.engine.warmup([worker.model.cfg.query_length + 8, 512, 1024, 2048])
    try:
        worker.register()
    except OSError as e:  # the controller is not up yet
        print(f"register error: {e} (the heartbeat retries)")
    worker.start_heartbeat()
    server = build_server(worker, host, port)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        while thread.is_alive() and worker.engine.broken is None:
            thread.join(timeout=1.0)
        if worker.engine.broken is not None:
            raise RuntimeError("the serving group fell out of step") from worker.engine.broken
    finally:
        server.shutdown()
        server.server_close()
        worker.shutdown()


def _chunk(text: str, error_code: int) -> bytes:
    return json.dumps({"text": text, "error_code": error_code}).encode() + b"\0"


def build_server(worker: ModelWorker, host: str = "127.0.0.1", port: int = 0):
    """The worker's HTTP server (httpd.make_server) with its three routes."""

    def worker_get_status(h, body):
        h.send_json(worker.get_status())

    def worker_generate_stream(h, payload):
        with worker.limit:
            h.start_stream()
            if payload.get("use_speculative"):
                try:
                    h.write_chunk(_chunk(worker.generate_speculative(payload), 0))
                except Exception as e:  # noqa: BLE001 — the client gets the failure
                    h.write_chunk(_chunk(f"{type(e).__name__}: {e}", 1))
                return
            try:
                req, prompt_text = worker.make_request(payload)
            except Exception as e:  # noqa: BLE001 — a malformed payload fails this request
                h.write_chunk(_chunk(f"{type(e).__name__}: {e}", 1))
                return
            worker.engine.submit(req)
            tok = worker.model.tokenizer
            generated: list[int] = []
            for kind, data in worker.events(req):
                if kind == "token":
                    generated.append(data)
                    h.write_chunk(_chunk(prompt_text + tok.decode(np.asarray(generated)), 0))
                elif kind == "error":
                    h.write_chunk(_chunk(str(data), 1))

    def chat_completions(h, body):
        """OpenAI-compatible endpoint (the reference's vLLM-API surface):
        messages whose content may hold {'type': 'image_url', 'image_url':
        {'url': 'data:...'}} parts; SSE `data:` chunks when stream is true."""
        image_b64 = None
        text_parts: list[dict] = []
        for msg in body.get("messages", []):
            content = msg.get("content")
            if isinstance(content, str):
                text_parts.append({"content": content})
            elif isinstance(content, list):
                for part in content:
                    if part.get("type") == "image_url":
                        image_b64 = part["image_url"]["url"].split(",", 1)[-1]
                    elif part.get("type") == "text":
                        text_parts.append({"content": part.get("text", "")})
        text_prompt = render_chat_template(text_parts)
        payload = {"task": "im2svg" if image_b64 else "text2svg", "image": image_b64,
                   "prompt": text_prompt if not image_b64 else None,
                   "max_new_tokens": int(body.get("max_tokens", 512)),
                   "temperature": float(body.get("temperature", 0.8)),
                   "top_p": float(body.get("top_p", 0.9))}
        with worker.limit:
            req, prompt_text = worker.make_request(payload)
            worker.engine.submit(req)
            tok = worker.model.tokenizer
            rid = "chatcmpl-" + req.request_id[:12]
            model_name = body.get("model", worker.model_names[0])
            if body.get("stream"):
                h.start_stream("text/event-stream")
                generated: list[int] = []
                prev = ""  # the first delta carries the '<svg' prompt
                for kind, data in worker.events(req):
                    if kind == "token":
                        generated.append(data)
                        text = prompt_text + tok.decode(np.asarray(generated))
                        delta, prev = text[len(prev):], text
                        chunk = {"id": rid, "object": "chat.completion.chunk", "model": model_name,
                                 "choices": [{"index": 0, "delta": {"content": delta},
                                              "finish_reason": None}]}
                        h.write_chunk(b"data: " + json.dumps(chunk).encode() + b"\n\n")
                    elif kind == "error":
                        # an engine failure is an SSE error event, not a [DONE]
                        err = {"id": rid, "object": "chat.completion.chunk", "model": model_name,
                               "error": {"message": str(data), "type": "engine_error"},
                               "choices": [{"index": 0, "delta": {}, "finish_reason": "error"}]}
                        h.write_chunk(b"data: " + json.dumps(err).encode() + b"\n\n")
                h.write_chunk(b"data: [DONE]\n\n")
                return
            generated = []
            for kind, data in worker.events(req):
                if kind == "done":
                    generated = data
                elif kind == "error":
                    h.send_json({"error": {"message": str(data), "type": "engine_error"}},
                                status=500)
                    return
            h.send_json({
                "id": rid, "object": "chat.completion", "model": model_name,
                "choices": [{"index": 0,
                             "message": {"role": "assistant",
                                         "content": prompt_text + tok.decode(np.asarray(generated))},
                             "finish_reason": "stop"}],
                "usage": {"completion_tokens": len(generated)},
            })

    return make_server(host, port, {"/worker_get_status": worker_get_status,
                                    "/worker_generate_stream": worker_generate_stream,
                                    "/v1/chat/completions": chat_completions})


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=21002)
    parser.add_argument("--model-path", required=True)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--controller", default=None)
    parser.add_argument("--worker-address", default=None)
    parser.add_argument("--limit-model-concurrency", type=int, default=5)
    parser.add_argument("--max-batch", type=int, default=8)
    parser.add_argument("--quantize", action="store_true",
                        help="int8 weight-only decoder (kernel 14)")
    parser.add_argument("--kv-int8", action="store_true", help="int8 KV cache")
    parser.add_argument("--spec-drafts", type=int, default=0,
                        help="engine prompt-lookup speculation: each tick becomes steps_per_tick "
                             "verify rounds drafting this many tokens on the device")
    parser.add_argument("--warmup", action="store_true",
                        help="run the admission and tick chain once per bucket before serving")
    parser.add_argument("--serve-config", default=None,
                        help="serve leaf yaml with the geometry (max_batch, max_len, kv dtype)")
    args = parser.parse_args(argv)
    device = require_device(args.device, "--device cpu")

    from starvector_tpu_torch.api import StarVectorForCausalLM

    max_batch, max_len, axes = args.max_batch, 8192, {}
    kv_dtype = torch.int8 if args.kv_int8 else None
    if args.serve_config:
        from starvector_tpu_torch.config import load_yaml

        kw = serve_kwargs_from_leaf(load_yaml(args.serve_config))
        max_batch, max_len, kv_dtype = kw["max_batch"], kw["max_len"], kw["kv_cache_dtype"]
        axes = kw["mesh_axes"]
    worker_kw = dict(max_len=max_len, kv_cache_dtype=kv_dtype, spec_drafts=args.spec_drafts,
                     limit_model_concurrency=args.limit_model_concurrency)
    if any(v > 1 for v in axes.values()):
        from starvector_tpu_torch.parallel.mesh import initialize_distributed
        from starvector_tpu_torch.parallel.tensor import serving_group

        device = initialize_distributed(device)
        group = serving_group(axes)
        model = StarVectorForCausalLM.from_pretrained(
            args.model_path, device=device, quantize=args.quantize,
            group=group if group.size > 1 else None)
        data = axes.get("replica", 1) * axes.get("data", 1)
        print(f"serve-config {kw.get('hbm_proof_case') or ''}: mesh {axes}, data group "
              f"{group.data_rank} rank {group.rank} of {group.size} (tensor rank "
              f"{group.tensor.rank} of {group.tensor.size}), B={max_batch} over {data} groups, "
              f"max_len={max_len}, kv={'int8' if kv_dtype is not None else 'bf16'}", flush=True)
        serve_rank(model, group, data=data, port=args.port, host=args.host,
                   worker_address=args.worker_address, controller=args.controller,
                   max_batch=max_batch, warmup=args.warmup, **worker_kw)
        return
    model = StarVectorForCausalLM.from_pretrained(args.model_path, device=device,
                                                  quantize=args.quantize)
    worker = ModelWorker(model, worker_addr=args.worker_address or f"http://localhost:{args.port}",
                         controller_addr=args.controller, max_batch=max_batch, **worker_kw)
    run_worker(worker, args.host, args.port, args.warmup)


if __name__ == "__main__":
    main()
