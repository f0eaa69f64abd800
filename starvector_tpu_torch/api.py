"""High-level API mirroring the reference quickstart surface (port of
starvector_tpu/api.py::StarVectorForCausalLM, im2svg and text2svg).

    model = StarVectorForCausalLM.from_pretrained(path, device="cuda")
    batch = {"image": model.process_images([image])}
    raw_svg = model.generate_im2svg(batch, max_length=4000)[0]
    svg = model.generate_text2svg({"caption": ["a red circle"]}, max_new_tokens=512)[0]
    loss = model.forward(batch_with_svg_ids)
    out = StarVectorPipeline(model)(image)  # {"raw_svg", "svg", "raster"}

Greedy and sampled im2svg and text2svg are ported for StarVector-1B and
StarVector-8B, in bf16 or fp32, or with int8 decoder weights
(`from_pretrained(..., quantize=True)`), with the JAX API's routes:
`num_beams > 1` runs beam search (generation/beam.py, with
`length_penalty`); `use_speculative=True` runs prompt-lookup speculative
decoding (generation/speculative.py, `draft_len`: B = 1 on the linear
cache, more rows on the ragged one; text2svg always the latter) when decoding is greedy with every penalty and bias neutral, and
plain decoding otherwise, as the JAX API's `spec_ok`;
`num_return_sequences = n` gives n rows a prompt, adjacent, each text
with its prompt. `generate_im2svg_grpo` is the rollout of
train/grpo.py's GRPOTrainer.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from starvector_tpu_torch import require_device
from starvector_tpu_torch.data.processor import processor_for_encoder
from starvector_tpu_torch.generation.beam import beam_search
from starvector_tpu_torch.generation.engine import (
    GenerationConfig, generate, generate_text2svg, im2svg_prefix,
)
from starvector_tpu_torch.generation.speculative import (
    generate_greedy_speculative, generate_greedy_speculative_batched,
)
from starvector_tpu_torch.models import starvector as sv
from starvector_tpu_torch.ops.layers import DTypePolicy

SVG_PROMPT = "<svg"  # the generation trigger (reference starcoder.py:39)


def spec_ok(gen: GenerationConfig) -> bool:
    """Speculative decoding emits the raw argmax: it is taken only where
    plain decoding's logit processors do nothing (the JAX API's guard)."""
    return (not gen.do_sample and gen.num_return_sequences == 1
            and gen.repetition_penalty == 1.0 and gen.frequency_penalty == 0.0
            and gen.presence_penalty == 0.0 and not gen.logit_bias
            # min_new_tokens acts only through eos suppression, which
            # speculative decoding does not do
            and (gen.eos_token_id is None or gen.min_new_tokens <= 1))


def tokenizer_version(cfg: sv.StarVectorConfig) -> str:
    """The tokenizer a decoder takes, as the JAX API chooses it: "v2"
    (<svg-end>, left padding) for StarCoder2, "v1" for GPTBigCode."""
    return "v2" if cfg.decoder == "starcoder2" else "v1"


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
        `seed`; fp32 weights compute in fp32, others in bf16. A tokenizer, if
        given, must be the decoder's version (tokenizer_version)."""
        if tokenizer is not None and tokenizer.version != tokenizer_version(cfg):
            raise ValueError(f"the {cfg.decoder} decoder takes a {tokenizer_version(cfg)} "
                             f"tokenizer, not {tokenizer.version}")
        device = require_device(device, 'device="cpu"')
        gen = torch.Generator(device=device).manual_seed(seed)
        params = sv.init_params(cfg, gen, device=device, dtype=dtype)
        compute = torch.float32 if dtype == torch.float32 else torch.bfloat16
        return cls(params, cfg, tokenizer, device=device,
                   policy=DTypePolicy(param_dtype=dtype, compute_dtype=compute))

    @classmethod
    def from_pretrained(cls, path: str, dtype=torch.bfloat16, device="cuda", *,
                        quantize: bool = False):
        """Load an HF-layout StarVector-1B or -8B checkpoint directory
        (model*.safetensors, config.json, tokenizer.json) through
        models/builder.py::load_pretrained_model; the tokenizer is the
        decoder's version (tokenizer_version). Needs the `safetensors` and
        `tokenizers` packages. `quantize=True` converts the decoder's large
        matmul weights to per-channel int8 (the JAX package's rule:
        `quantize_tree` on the decoder only, at its default threshold: the
        1B's four projections a layer, the 8B's six; the vision tower,
        adapter, embeddings and norms keep `dtype`)."""
        from starvector_tpu_torch.models.builder import load_pretrained_model
        from starvector_tpu_torch.ops.quantization import quantize_tree

        params, cfg, tokenizer, _, _ = load_pretrained_model(path, dtype, device)
        if quantize:
            params["svg_transformer"] = quantize_tree(params["svg_transformer"])
        return cls(params, cfg, tokenizer, device=device,
                   policy=DTypePolicy(param_dtype=dtype, compute_dtype=torch.bfloat16))

    # -- reference surface --------------------------------------------------
    def process_images(self, images: Sequence[Any]) -> torch.Tensor:
        """uint8 (H, W, 3|4) arrays or PIL images -> (B, H, W, 3) normalized."""
        return self.processor.batch(images)

    def forward(self, batch: dict) -> torch.Tensor:
        """The training loss of a batch (the loader's keys: image, svg_ids,
        svg_mask; or text2svg's input_ids, input_mask), with the adapter's
        running statistics and no dropout, as the JAX forward."""
        from starvector_tpu_torch.train.train import to_device

        pad = self.tokenizer.pad_token_id if self.tokenizer is not None else 0
        return sv.loss_fn(self.params, self.cfg, to_device(batch, self.device), pad,
                          policy=self.policy, kernels=self.kernels)

    def _gen_config(self, kwargs: dict, stop_sequences, *,
                    text2svg: bool = False) -> GenerationConfig:
        """Map the reference's generation kwargs onto the engine config;
        text2svg also stops on the tokenizer's eos."""
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
            eos_token_id=self.tokenizer.eos_token_id if text2svg else None,
            pad_token_id=self.tokenizer.pad_token_id if self.tokenizer is not None
            else int(kwargs.get("pad_token_id", 0)),
        )

    def _spec_kwargs(self, gen: GenerationConfig, kwargs: dict) -> dict:
        return dict(max_new_tokens=gen.max_new_tokens, draft_len=int(kwargs.get("draft_len", 8)),
                    stop_sequences=gen.stop_sequences, eos_token_id=gen.eos_token_id,
                    pad_token_id=gen.pad_token_id, policy=self.policy, kernels=self.kernels)

    def _im2svg_request(self, batch: dict, prompt_ids, stop_sequences, kwargs: dict):
        """(images, prompt_ids (B, Sp) on the device, GenerationConfig)."""
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
        return images, prompt_ids, self._gen_config(kwargs, tuple(tuple(s) for s in stop_sequences))

    @torch.no_grad()
    def _im2svg(self, batch: dict, prompt_ids, stop_sequences, kwargs: dict):
        """(prompt_ids (B x n, Sp), tokens, lengths, speculative?) by the
        JAX API's route: beams, speculative or plain decoding."""
        images, prompt_ids, gen = self._im2svg_request(batch, prompt_ids, stop_sequences, kwargs)
        dec_params = self.params["svg_transformer"]
        num_beams = int(kwargs.get("num_beams", 1))
        speculative = bool(kwargs.get("use_speculative")) and spec_ok(gen) and num_beams <= 1
        prefix, mask = im2svg_prefix(self.params, self.cfg, images, prompt_ids, policy=self.policy)
        if num_beams > 1:
            tokens, lengths = beam_search(
                dec_params, self.cfg.llm, prefix, mask, num_beams=num_beams,
                max_new_tokens=gen.max_new_tokens, stop_sequences=gen.stop_sequences,
                eos_token_id=gen.eos_token_id, pad_token_id=gen.pad_token_id,
                length_penalty=float(kwargs.get("length_penalty", 1.0)), policy=self.policy,
                kernels=self.kernels)
            return prompt_ids, tokens, lengths, False
        if speculative:
            B, Sp = prompt_ids.shape
            # the draft's context: -1 over the visual tokens, then the prompt
            ids = torch.cat([torch.full((B, prefix.shape[1] - Sp), -1, dtype=torch.int64,
                                        device=self.device), prompt_ids], dim=1)
            run = generate_greedy_speculative if B == 1 else generate_greedy_speculative_batched
            tokens, lengths, _ = run(dec_params, self.cfg.llm, prefix, mask, ids,
                                     **self._spec_kwargs(gen, kwargs))
            return prompt_ids, tokens, lengths, True
        tokens, lengths = generate(dec_params, self.cfg.llm, prefix, mask, gen, self.generator,
                                   prompt_ids=prompt_ids, policy=self.policy,
                                   kernels=self.kernels)
        return prompt_ids.repeat_interleave(gen.num_return_sequences, dim=0), tokens, lengths, False

    def generate_im2svg_ids(self, batch: dict, *, prompt_ids=None, stop_sequences=None,
                            **kwargs):
        """im2svg as token ids: returns (prompt_ids (B x n, Sp), tokens
        (B x n, max_new_tokens), lengths (B x n,)), n = num_return_sequences
        (1 for beams and speculative decoding). Without a tokenizer, pass
        `prompt_ids` and `stop_sequences` (tuples of ids)."""
        return self._im2svg(batch, prompt_ids, stop_sequences, kwargs)[:3]

    def generate_im2svg(self, batch: dict, **kwargs) -> list[str]:
        """Reference generate_im2svg: decoded text includes the prompt prefix
        ("<svg" ...), as the reference's torch.cat([prompt, outputs]) does
        (the speculative route, as the JAX API's, decodes the two apart and
        joins the texts)."""
        if self.tokenizer is None:
            raise ValueError("generate_im2svg decodes text and needs a tokenizer; "
                             "use generate_im2svg_ids without one")
        prompt_ids, tokens, lengths, speculative = self._im2svg(
            batch, kwargs.pop("prompt_ids", None), kwargs.pop("stop_sequences", None), kwargs)
        P = prompt_ids.shape[1]
        prompts, tokens = prompt_ids.cpu().numpy(), tokens.cpu().numpy()
        if speculative:
            return [self.tokenizer.decode(p) + self.tokenizer.decode(row[:int(L)])
                    for p, row, L in zip(prompts, tokens, lengths.tolist())]
        outs = np.concatenate([prompts, tokens], axis=1)
        return [self.tokenizer.decode(row[:P + int(L)]) for row, L in zip(outs, lengths.tolist())]

    @torch.no_grad()
    def generate_im2svg_grpo(self, batch: dict, *, prompt_ids=None, stop_sequences=None,
                             **kwargs) -> dict:
        """Reference generate_im2svg_grpo: grouped rollouts for RL. The image
        is encoded once; its [visual ‖ prompt] embeddings serve the sampling
        (num_return_sequences rows an image, adjacent) and are returned.
        Returns {"raw_svg": the decoded texts with their prompt (None
        without a tokenizer), "outputs": [prompt ‖ tokens] ids (B x n,
        Sp + max_new_tokens), "lengths": generated lengths (B x n,),
        "inputs_embeds": (B, Q + Sp, E), "prompt_len": Sp}."""
        images, prompt_ids, gen = self._im2svg_request(batch, prompt_ids, stop_sequences, kwargs)
        inputs_embeds, mask = im2svg_prefix(self.params, self.cfg, images, prompt_ids,
                                            policy=self.policy)
        tokens, lengths = generate(self.params["svg_transformer"], self.cfg.llm, inputs_embeds,
                                   mask, gen, self.generator, prompt_ids=prompt_ids,
                                   policy=self.policy, kernels=self.kernels)
        P = prompt_ids.shape[1]
        outputs = torch.cat([prompt_ids.repeat_interleave(gen.num_return_sequences, dim=0),
                             tokens], dim=1)
        raw_svg = None
        if self.tokenizer is not None:
            raw_svg = [self.tokenizer.decode(row[:P + int(L)])
                       for row, L in zip(outputs.cpu().numpy(), lengths.tolist())]
        return {"raw_svg": raw_svg, "outputs": outputs, "lengths": lengths,
                "inputs_embeds": inputs_embeds, "prompt_len": P}

    def _caption_ids(self, captions: Sequence[str], max_length: int):
        """caption + <svg-start> ids, truncated to max_length, as (B, S)
        int64 ids and int32 mask on the device, left-padded: a right-padded
        row (the v1 tokenizer pads right) is moved left, since the engine
        reads the prompt's last logits at the last position."""
        tok = self.tokenizer
        enc = tok([c + tok.svg_start_token for c in captions], max_length=max_length,
                  add_special_tokens=False)
        ids, mask = enc["input_ids"], enc["attention_mask"]
        if (mask[:, -1] == 0).any():
            left_ids, left_mask = np.full_like(ids, tok.pad_token_id), np.zeros_like(mask)
            for b in range(ids.shape[0]):
                row = ids[b][mask[b] > 0]
                left_ids[b, ids.shape[1] - len(row):] = row
                left_mask[b, ids.shape[1] - len(row):] = 1
            ids, mask = left_ids, left_mask
        return (torch.as_tensor(ids, device=self.device).long(),
                torch.as_tensor(mask, device=self.device))

    @torch.no_grad()
    def generate_text2svg_ids(self, batch: dict, **kwargs):
        """text2svg as token ids: batch["caption"] is a list of captions.
        Returns (input_ids (B x n, S) left-padded, tokens (B x n,
        max_new_tokens), lengths (B x n,)); generation stops on `</svg>` or
        eos. The speculative route moves each row's ids to the right (the
        ragged cache holds a row's keys from slot 0), as the JAX API does."""
        if self.tokenizer is None:
            raise ValueError("text2svg tokenizes its captions and needs a tokenizer")
        ids, mask = self._caption_ids(batch["caption"], kwargs.get("max_length", 30))
        gen = self._gen_config(kwargs, (self.tokenizer.stop_sequence_ids("</svg>"),),
                               text2svg=True)
        if kwargs.get("use_speculative") and spec_ok(gen):
            n_real = mask.sum(dim=1, keepdim=True)
            col = torch.arange(ids.shape[1], device=self.device)[None, :]
            mask_r = (col < n_real).to(torch.int32)
            # row b's real ids, moved from the end to the start
            src = torch.clamp(col + ids.shape[1] - n_real, max=ids.shape[1] - 1)
            ids_r = torch.where(mask_r > 0, ids.gather(1, src), 0)
            embeds = self.policy.cast(self.cfg.decoder_module.embed_tokens(
                self.params["svg_transformer"], ids_r))
            tokens, lengths, _ = generate_greedy_speculative_batched(
                self.params["svg_transformer"], self.cfg.llm, embeds, mask_r,
                torch.where(mask_r > 0, ids_r, -1), **self._spec_kwargs(gen, kwargs))
            return ids, tokens, lengths
        tokens, lengths = generate_text2svg(self.params, self.cfg, ids, mask, gen,
                                            self.generator, policy=self.policy,
                                            kernels=self.kernels)
        return ids.repeat_interleave(gen.num_return_sequences, dim=0), tokens, lengths

    def generate_text2svg(self, batch: dict, **kwargs) -> list[str]:
        """Reference generate_text2svg: the decoded text holds the generated
        tokens only, not the caption."""
        _, tokens, lengths = self.generate_text2svg_ids(batch, **kwargs)
        return [self.tokenizer.decode(row[:int(L)])
                for row, L in zip(tokens.cpu().numpy(), lengths.tolist())]


@dataclasses.dataclass
class StarVectorPipeline:
    """image -> svg -> raster, the reference quickstart's tail
    (process_and_rasterize_svg from the port's data/rasterize.py)."""

    model: StarVectorForCausalLM

    def __call__(self, image, **kwargs) -> dict:
        from starvector_tpu_torch.data.rasterize import process_and_rasterize_svg

        raw = self.model.generate_im2svg({"image": self.model.process_images([image])},
                                         **kwargs)[0]
        svg, raster = process_and_rasterize_svg(raw)
        return {"raw_svg": raw, "svg": svg, "raster": raster}
