"""Validator backend that evaluates THROUGH the serving REST API (the port
of starvector_tpu/validation/serve_validator.py, on urllib; reference vLLM-
API validator equivalent: starvector/validation/
starvector_vllm_api_svg_validator.py:13-76 — HTTP requests against a
running worker/controller, streamed chunks reassembled). It drives the
port's worker (serve/worker.py) or the JAX package's alike."""

from __future__ import annotations

import base64
import io
import json

import numpy as np

from starvector_tpu_torch.serve.httpd import post_json
from starvector_tpu_torch.validation.svg_validator_base import SVGValidator, register_validator


@register_validator
class StarVectorServeValidator(SVGValidator):
    def __init__(self, config):
        super().__init__(config)
        self.endpoint = str(config.get_path("model.api_endpoint", "http://localhost:21002"))
        self.model_name = config.get_path("model.name", "starvector")

    def get_dataloader(self):
        for items in self.iter_dataset_batches(default_batch_size=1):
            yield {
                "image_pil": [s.get("image_pil") for s in items],
                "image": [np.asarray(s["image"]) for s in items],
                "svg": [s["svg"] for s in items],
                "id": [s["id"] for s in items],
                "caption": [s["caption"] for s in items],
            }

    def _stream_one(self, payload: dict) -> str:
        # infrastructure failures must RAISE, not score as an empty
        # generation (a silent '' becomes a placeholder SVG and corrupts
        # the no-compile ratio / every image metric): urllib raises
        # HTTPError on an error status, an error chunk raises below
        with post_json(self.endpoint + "/worker_generate_stream", payload, 600) as resp:
            raw = resp.read()
        text = ""
        for chunk in raw.split(b"\0"):
            if chunk:
                data = json.loads(chunk)
                if data.get("error_code", 0) != 0:
                    raise RuntimeError(
                        f"worker stream error {data.get('error_code')}: "
                        f"{data.get('text', '')[:200]}"
                    )
                text = data["text"]
        return text

    def generate_svg(self, batch, generate_config):
        from starvector_tpu_torch.data.rasterize import rasterize_svg

        outputs = []
        for i in range(len(batch["svg"])):
            pil = batch.get("image_pil", [None] * len(batch["svg"]))[i]
            if pil is None:
                # rasterize the GT svg as the model input (reference HF
                # validator behavior)
                pil = rasterize_svg(batch["svg"][i], resolution=224)
            buf = io.BytesIO()
            pil.save(buf, format="PNG")
            payload = {
                "model": self.model_name,
                "task": self.task,
                "image": base64.b64encode(buf.getvalue()).decode(),
                "max_new_tokens": int(generate_config.get("max_new_tokens", 512)),
                "temperature": float(generate_config.get("temperature", 0.0)),
                "top_p": float(generate_config.get("top_p", 0.9)),
            }
            # full vLLM sampling surface (reference SamplingParams,
            # starvector_vllm_svg_validator.py:35-44; logit_bias toward
            # `</svg>`, ..._api_svg_validator.py:60)
            for knob in ("top_k", "min_p", "repetition_penalty",
                         "frequency_penalty", "presence_penalty"):
                if knob in generate_config:
                    payload[knob] = float(generate_config[knob])
            if generate_config.get("logit_bias"):
                payload["logit_bias"] = dict(generate_config["logit_bias"])
            if self.task == "text2svg":
                payload["prompt"] = batch["caption"][i]
            outputs.append(self._stream_one(payload))
        return outputs
