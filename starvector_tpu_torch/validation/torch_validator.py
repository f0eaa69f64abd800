"""The in-process validator backend (the port of starvector_tpu/validation/
jax_validator.py; reference HF validator equivalent:
starvector/validation/starvector_hf_validator.py:43-88 — rasterizes the GT
SVG as model input, runs generate_im2svg / generate_text2svg, greedy when
temperature == 0).

The model loads with StarVectorForCausalLM.from_pretrained(
model.from_checkpoint) on `model.device`: the card, or the CPU when the
config says `model.device: cpu`; generation kwargs pass through to the
API as they are (num_beams, use_speculative, ...)."""

from __future__ import annotations

import numpy as np
import torch

from starvector_tpu_torch import require_device
from starvector_tpu_torch.validation.svg_validator_base import SVGValidator, register_validator


@register_validator
class StarVectorTorchValidator(SVGValidator):
    def __init__(self, config, model=None):
        """`model`: an api.StarVectorForCausalLM to use instead of loading
        model.from_checkpoint (tests); its device is the validator's."""
        if model is None:
            device = require_device(config.get_path("model.device", "cuda"), "model.device=cpu")
            ckpt = config.get_path("model.from_checkpoint")
            if not ckpt:
                raise ValueError("model.from_checkpoint required for the in-process engine")
        else:
            device = model.device
        super().__init__(config, device=device)
        if model is None:
            from starvector_tpu_torch.api import StarVectorForCausalLM

            model = StarVectorForCausalLM.from_pretrained(str(ckpt), device=device)
        self.model = model

    def get_dataloader(self):
        for items in self.iter_dataset_batches(default_batch_size=2):
            yield {
                "image": torch.as_tensor(np.stack([np.asarray(s["image"]) for s in items]),
                                         device=self.model.device),
                "svg": [s["svg"] for s in items],
                "id": [s["id"] for s in items],
                "caption": [s["caption"] for s in items],
            }

    def generate_svg(self, batch, generate_config):
        kwargs = dict(generate_config)
        kwargs.pop("generation_sweep", None)
        temp = float(kwargs.get("temperature", 1.0))
        if temp == 0.0:
            # temp==0 → greedy (reference starvector_hf_validator.py:77-83)
            kwargs["use_nucleus_sampling"] = False
        if "max_length" in kwargs and "max_new_tokens" not in kwargs:
            kwargs["max_new_tokens"] = int(kwargs.pop("max_length"))
        if self.task == "im2svg":
            return self.model.generate_im2svg({"image": batch["image"]}, **kwargs)
        return self.model.generate_text2svg({"caption": batch["caption"]}, **kwargs)
