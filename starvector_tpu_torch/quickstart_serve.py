"""Batched image -> SVG through the continuous-batching engine (port of
scripts/quickstart-serve.py, the reference's vLLM quickstart):

    python -m starvector_tpu_torch.quickstart_serve <checkpoint|--random-tiny> img1.png [img2.png ...] [--device cpu]

Runs on the card unless `--device cpu`.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from starvector_tpu_torch import require_device
from starvector_tpu_torch.quickstart import pop_device


@torch.inference_mode()
def serve_images(model, paths, max_tokens: int) -> tuple[list[str], dict]:
    """Greedy SVG text of each image in `paths` through a ServeEngine on
    `model` (an api.StarVectorForCausalLM with a tokenizer): max_batch
    min(8, n), max_len 8192, each prefix the tower's embeddings followed by
    the '<svg' prompt's, stopping on '</svg>'. Every request is submitted
    once before any is read (the JAX script's generate_sync submits each a
    second time). Returns (the texts, prompt included, in the order of
    `paths`; the engine's stats())."""
    from PIL import Image

    from starvector_tpu_torch.models import starvector as sv
    from starvector_tpu_torch.serve.engine import Request, ServeEngine

    engine = ServeEngine(model.params["svg_transformer"], model.cfg.llm, model.cfg.decoder,
                         max_batch=min(8, len(paths)), max_len=8192, policy=model.policy,
                         device=model.device, kernels=model.kernels)
    engine.start()
    tok = model.tokenizer
    try:
        reqs = []
        for p in paths:
            images = model.process_images([Image.open(p)])
            cond = sv.encode_image(model.params, model.cfg, images, policy=model.policy)
            ids = torch.tensor(tok([tok.prompt], add_special_tokens=False)["input_ids"],
                               device=model.device)
            pe = model.cfg.decoder_module.embed_tokens(model.params["svg_transformer"], ids)
            prefix = torch.cat([cond, model.policy.cast(pe)], dim=1)
            reqs.append(engine.submit(Request(
                prefix_embeds=prefix, max_new_tokens=max_tokens, do_sample=False,
                stop_sequences=(tok.stop_sequence_ids("</svg>"),))))
        texts = [tok.prompt + tok.decode(np.asarray(engine.result(r))) for r in reqs]
        return texts, engine.stats()
    finally:
        engine.stop()


def main(argv: list[str] | None = None) -> None:
    args = list(sys.argv[1:] if argv is None else argv)
    device = pop_device(args)
    if len(args) < 2:
        print(__doc__)
        sys.exit(1)
    ckpt, paths = args[0], args[1:]
    device = require_device(device, "--device cpu")

    from starvector_tpu_torch.api import StarVectorForCausalLM

    if ckpt == "--random-tiny":
        from starvector_tpu_torch.models import starvector as sv
        from starvector_tpu_torch.models.tokenizer import build_test_tokenizer

        model = StarVectorForCausalLM.from_config(sv.tiny_config(), device=device,
                                                  tokenizer=build_test_tokenizer("v1"))
        max_tokens = 24
    else:
        model = StarVectorForCausalLM.from_pretrained(ckpt, device=device)
        max_tokens = 4000
    texts, _ = serve_images(model, paths, max_tokens)
    for p, text in zip(paths, texts):
        print(f"=== {p} ===")
        print(text)


if __name__ == "__main__":
    main()
