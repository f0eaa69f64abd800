"""Validation CLI (the port of starvector_tpu/validation/validate.py;
reference: starvector/validation/validate.py:8-56). It reads the repo's
eval configs as they are; the in-process engine runs on the card unless
`model.device=cpu`.

    python -m starvector_tpu_torch.validation.validate \\
        config=configs/generation/jax/starvector-1b/im2svg.yaml \\
        model.from_checkpoint=/path/to/ckpt dataset.num_samples=32
"""

from __future__ import annotations

from starvector_tpu_torch.config import get_config

ENGINES = {
    # the configs' engine names (the JAX package's and the reference's)
    # map to the port's backends
    "jax": "StarVectorTorchValidator",
    "hf": "StarVectorTorchValidator",
    "vllm": "StarVectorServeValidator",
    "vllm-api": "StarVectorServeValidator",
}


def get_validator(config):
    # importing registers the validators
    from starvector_tpu_torch.validation import serve_validator, torch_validator  # noqa: F401
    from starvector_tpu_torch.validation.svg_validator_base import validator_registry

    engine = config.get_path("model.generation_engine", "jax")
    name = ENGINES.get(engine, engine)
    if name not in validator_registry:
        raise ValueError(
            f"engine {engine!r} → {name!r} not registered; "
            f"available: {list(validator_registry)}"
        )
    return validator_registry[name](config)


def main():
    config = get_config()
    validator = get_validator(config)
    avg, _ = validator.validate()
    print(avg)


if __name__ == "__main__":
    main()
