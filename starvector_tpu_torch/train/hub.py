"""HF checkpoint export and Hub push (port of starvector_tpu/train/hub.py).

`export_hf_checkpoint` writes a StarVector checkpoint directory in the
reference HF layout from the port's parameters: model.safetensors under
the reference state-dict names (models/export.py), config.json with the
JAX package's keys, and tokenizer.json. models/builder.py's
load_pretrained_model and the JAX package's load_hf_starvector_checkpoint
both read it back. `push_model_to_hub` uploads such a directory.
"""

from __future__ import annotations

import json
import os


def export_hf_checkpoint(params: dict, cfg, tokenizer, out_dir: str, *,
                         starcoder_model_name: str | None = None) -> str:
    """Write an HF-loadable StarVector checkpoint directory; returns it."""
    from starvector_tpu_torch.models import export

    os.makedirs(out_dir, exist_ok=True)
    if cfg.decoder == "gpt_bigcode":
        sd = export.gpt_bigcode_to_hf(params["svg_transformer"], cfg.llm,
                                      prefix="model.svg_transformer.transformer.transformer.")
        default_name = "bigcode/starcoderbase-1b"
    else:
        sd = export.starcoder2_to_hf(params["svg_transformer"], cfg.llm,
                                     prefix="model.svg_transformer.transformer.model.")
        default_name = "bigcode/starcoder2-7b"
    if "image_encoder" in params:
        sd.update(export.vision_to_hf(params, cfg))
    export.save_safetensors(sd, os.path.join(out_dir, "model.safetensors"))
    del sd

    tower = cfg.encoder_config.tower_config if cfg.use_image_encoder else None
    hf_cfg = {
        "model_type": "starvector",
        "starcoder_model_name": starcoder_model_name or default_name,
        # geometry the weights' shapes do not give, so that a round trip
        # needs nothing but the directory
        "vision_geometry": {"heads": tower.heads} if hasattr(tower, "heads") else {},
        "llm_geometry": {
            "head_dim": cfg.llm.head_dim,
            "rope_theta": getattr(cfg.llm, "rope_theta", None),
            "sliding_window": getattr(cfg.llm, "sliding_window", None),
        },
        "image_encoder_type": cfg.image_encoder_type,
        "adapter_norm": cfg.adapter_norm,
        "image_size": cfg.image_size,
        "max_length": cfg.max_length_train,
        "task": cfg.task,
    }
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(hf_cfg, f, indent=2)
    if hasattr(tokenizer, "tokenizer"):
        tokenizer.tokenizer.save(os.path.join(out_dir, "tokenizer.json"))
    return out_dir


def push_model_to_hub(repo_id: str, checkpoint_dir: str, *, token: str | None = None,
                      private: bool = True, commit_message: str | None = None) -> str:
    """Upload an exported checkpoint directory to the HF Hub (needs the
    `huggingface_hub` package and a reachable Hub); returns the repo URL."""
    from huggingface_hub import HfApi

    api = HfApi(token=token)
    api.create_repo(repo_id, private=private, exist_ok=True)
    api.upload_folder(folder_path=checkpoint_dir, repo_id=repo_id,
                      commit_message=commit_message
                      or f"upload {os.path.basename(checkpoint_dir)}")
    return f"https://huggingface.co/{repo_id}"
