"""High-level API mirroring the reference quickstart surface (port of
starvector_tpu/api.py::StarVectorForCausalLM, im2svg).

    model = StarVectorForCausalLM.from_pretrained(path, device="cuda")
    batch = {"image": model.process_images([image])}
    raw_svg = model.generate_im2svg(batch, max_length=4000)[0]

Greedy and sampled im2svg are ported, with int8 decoder weights
(`from_pretrained(..., quantize=True)`). Beam search, speculative decoding,
GRPO rollouts and text2svg raise NotImplementedError naming their ROADMAP
item.
"""

from __future__ import annotations

import json
import os
from typing import Any, Sequence

import torch

from starvector_tpu_torch import require_device
from starvector_tpu_torch.data.processor import processor_for_encoder
from starvector_tpu_torch.generation.engine import GenerationConfig, generate_im2svg
from starvector_tpu_torch.models import starvector as sv
from starvector_tpu_torch.ops.layers import DTypePolicy

SVG_PROMPT = "<svg"  # the generation trigger (reference starcoder.py:39)


class StarVectorForCausalLM:
    def __init__(self, params: dict, cfg: sv.StarVectorConfig, tokenizer=None, *,
                 policy: DTypePolicy | None = None, device="cuda",
                 generator: torch.Generator | None = None, kernels: bool = True):
        """`tokenizer` is a starvector_tpu_torch.models.tokenizer.SVGTokenizer,
        or None: then prompts and stop sequences are given as token ids.
        `kernels=False` runs the kernels' plain versions. Runs on the card;
        `device="cpu"` asks for the CPU."""
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.policy = policy or DTypePolicy()
        self.device = require_device(device, 'device="cpu"')
        self.kernels = kernels
        self.processor = processor_for_encoder(cfg.image_encoder_type, cfg.image_size,
                                               device=self.device)
        self.generator = generator or torch.Generator(device=self.device).manual_seed(0)

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_config(cls, cfg: sv.StarVectorConfig, *, seed: int = 0, tokenizer=None,
                    dtype=torch.float32, device="cuda"):
        """Random weights drawn on `device` from a torch.Generator seeded with
        `seed`; fp32 weights compute in fp32, others in bf16."""
        device = require_device(device, 'device="cpu"')
        gen = torch.Generator(device=device).manual_seed(seed)
        params = sv.init_params(cfg, gen, device=device, dtype=dtype)
        compute = torch.float32 if dtype == torch.float32 else torch.bfloat16
        return cls(params, cfg, tokenizer, device=device,
                   policy=DTypePolicy(param_dtype=dtype, compute_dtype=compute))

    @classmethod
    def from_pretrained(cls, path: str, dtype=torch.bfloat16, device="cuda", *,
                        quantize: bool = False):
        """Load an HF-layout StarVector-1B checkpoint directory
        (model*.safetensors, config.json, tokenizer.json). Needs the
        `safetensors` and `tokenizers` packages. `quantize=True` converts the
        decoder's large matmul weights to per-channel int8 (the JAX
        package's rule: `quantize_tree` on the decoder only; the vision
        tower, adapter and embeddings keep `dtype`)."""
        from safetensors.numpy import load_file

        from starvector_tpu_torch.models.convert import config_from_hf, from_hf_state_dict
        from starvector_tpu_torch.models.tokenizer import load_tokenizer
        from starvector_tpu_torch.ops.quantization import quantize_tree

        device = require_device(device, 'device="cpu"')

        sd: dict = {}
        for name in sorted(os.listdir(path)):
            if name.endswith(".safetensors"):
                sd.update(load_file(os.path.join(path, name)))
        with open(os.path.join(path, "config.json")) as f:
            hf_cfg = json.load(f)
        cfg = config_from_hf(sd, hf_cfg)
        params = from_hf_state_dict(sd, dtype=dtype, device=device)
        del sd
        if quantize:
            params["svg_transformer"] = quantize_tree(params["svg_transformer"])
        return cls(params, cfg, load_tokenizer(path, version="v1"), device=device,
                   policy=DTypePolicy(param_dtype=dtype, compute_dtype=torch.bfloat16))

    # -- reference surface --------------------------------------------------
    def process_images(self, images: Sequence[Any]) -> torch.Tensor:
        """uint8 (H, W, 3|4) arrays or PIL images -> (B, H, W, 3) normalized."""
        return self.processor.batch(images)

    def _gen_config(self, kwargs: dict, stop_sequences) -> GenerationConfig:
        """Map the reference's generation kwargs onto the engine config."""
        max_length = kwargs.get("max_length", 30)
        return GenerationConfig(
            max_new_tokens=int(kwargs.get("max_new_tokens", max_length)),
            min_new_tokens=int(kwargs.get("min_length", 1)),
            do_sample=bool(kwargs.get("use_nucleus_sampling", True)),
            temperature=float(kwargs.get("temperature", 1.0)),
            top_p=float(kwargs.get("top_p", 0.9)),
            top_k=int(kwargs.get("top_k", 0)),
            min_p=float(kwargs.get("min_p", 0.0)),
            repetition_penalty=float(kwargs.get("repetition_penalty", 1.0)),
            frequency_penalty=float(kwargs.get("frequency_penalty", 0.0)),
            presence_penalty=float(kwargs.get("presence_penalty", 0.0)),
            logit_bias=tuple((int(t), float(b))
                             for t, b in dict(kwargs.get("logit_bias") or {}).items()),
            num_return_sequences=int(kwargs.get("num_return_sequences", 1)),
            stop_sequences=stop_sequences,
            eos_token_id=None,  # im2svg stops on </svg> only
            pad_token_id=self.tokenizer.pad_token_id if self.tokenizer is not None
            else int(kwargs.get("pad_token_id", 0)),
        )

    def generate_im2svg_ids(self, batch: dict, *, prompt_ids=None, stop_sequences=None,
                            **kwargs):
        """im2svg as token ids: returns (prompt_ids (B, Sp), tokens
        (B, max_new_tokens), lengths (B,)). Without a tokenizer, pass
        `prompt_ids` and `stop_sequences` (tuples of ids)."""
        if int(kwargs.get("num_beams", 1)) > 1:
            raise NotImplementedError("beam search is not ported yet (ROADMAP queue 1, item 7)")
        if kwargs.get("use_speculative"):
            raise NotImplementedError(
                "speculative decoding is not ported yet (ROADMAP queue 1, item 7)")
        images = torch.as_tensor(batch["image"], device=self.device)
        B = images.shape[0]
        if prompt_ids is None:
            if self.tokenizer is None:
                raise ValueError("no tokenizer: pass prompt_ids")
            prompt = kwargs.get("prompt") or SVG_PROMPT
            prompt_ids = self.tokenizer([prompt] * B, add_special_tokens=False)["input_ids"]
        if stop_sequences is None:
            if self.tokenizer is None:
                raise ValueError("no tokenizer: pass stop_sequences")
            stop_sequences = (self.tokenizer.stop_sequence_ids("</svg>"),)
        prompt_ids = torch.as_tensor(prompt_ids, device=self.device).long()
        gen = self._gen_config(kwargs, tuple(tuple(s) for s in stop_sequences))
        tokens, lengths = generate_im2svg(self.params, self.cfg, images, prompt_ids, gen,
                                          self.generator, policy=self.policy,
                                          kernels=self.kernels)
        return prompt_ids, tokens, lengths

    def generate_im2svg(self, batch: dict, **kwargs) -> list[str]:
        """Reference generate_im2svg: decoded text includes the prompt prefix
        ("<svg" ...), as the reference's torch.cat([prompt, outputs]) does."""
        if self.tokenizer is None:
            raise ValueError("generate_im2svg decodes text and needs a tokenizer; "
                             "use generate_im2svg_ids without one")
        prompt_ids, tokens, lengths = self.generate_im2svg_ids(batch, **kwargs)
        outs = torch.cat([prompt_ids, tokens], dim=1).cpu().numpy()
        P = prompt_ids.shape[1]
        return [self.tokenizer.decode(row[:P + int(L)]) for row, L in zip(outs, lengths.tolist())]

    def generate_im2svg_grpo(self, batch: dict, **kwargs):
        raise NotImplementedError("GRPO rollouts are not ported yet (ROADMAP queue 1, item 7)")

    def generate_text2svg(self, batch: dict, **kwargs):
        raise NotImplementedError("text2svg is not ported yet (ROADMAP queue 1, item 5)")
