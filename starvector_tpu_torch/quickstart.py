"""Quickstart: image -> SVG with a local StarVector checkpoint (port of
scripts/quickstart.py):

    python -m starvector_tpu_torch.quickstart <checkpoint_dir> <image.png> [max_tokens] [--device cpu]

Without a checkpoint, pass "--random-tiny" to smoke-test the pipeline with a
randomly initialized tiny model. Runs on the card unless `--device cpu`.
"""

from __future__ import annotations

import sys

from starvector_tpu_torch import require_device


def pop_device(args: list[str]) -> str:
    """Remove `--device X` from args and return X ("cuda" without it)."""
    if "--device" not in args:
        return "cuda"
    i = args.index("--device")
    if i + 1 >= len(args):
        raise SystemExit("--device takes a value: cuda or cpu")
    device = args[i + 1]
    del args[i:i + 2]
    return device


def main(argv: list[str] | None = None) -> None:
    args = list(sys.argv[1:] if argv is None else argv)
    device = pop_device(args)
    if len(args) < 2:
        print(__doc__)
        sys.exit(1)
    ckpt, image_path = args[0], args[1]
    max_tokens = int(args[2]) if len(args) > 2 else 4000
    device = require_device(device, "--device cpu")

    from PIL import Image

    from starvector_tpu_torch.api import StarVectorForCausalLM, StarVectorPipeline

    if ckpt == "--random-tiny":
        from starvector_tpu_torch.models import starvector as sv
        from starvector_tpu_torch.models.tokenizer import build_test_tokenizer

        model = StarVectorForCausalLM.from_config(sv.tiny_config(), device=device,
                                                  tokenizer=build_test_tokenizer("v1"))
        max_tokens = min(max_tokens, 32)
    else:
        model = StarVectorForCausalLM.from_pretrained(ckpt, device=device)

    pipe = StarVectorPipeline(model)
    result = pipe(Image.open(image_path), max_new_tokens=max_tokens, use_nucleus_sampling=False)
    print(result["svg"])


if __name__ == "__main__":
    main()
