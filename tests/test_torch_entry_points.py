"""The port's entry points against the JAX package's scripts, on the CPU:

  * the GRPO driver (`python -m starvector_tpu_torch.train.grpo`) and
    scripts/train_grpo.py (run through runpy with sys.argv; nothing in
    scripts/ is edited) on the same tiny config and ToySVGDataset, 2 steps,
    a checkpoint every step, 1 kept: the same metrics keys each step (the
    port's trainer adds its three wall-time keys, rollout_s, reward_s and
    update_s), the same number of steps logged and the same checkpoint
    directory left. The values differ: the two packages' rollouts sample
    from different generators (jax.random, torch.Generator). Both rewards
    are a stand-in (the render reward starts a worker process for every
    invalid rollout, seconds each);
  * the quickstart (`python -m starvector_tpu_torch.quickstart`) and
    scripts/quickstart.py on one tiny checkpoint that the JAX package's
    export writes, 16 tokens: the same printed SVG in the default bf16, and
    the same raw text in fp32 through both StarVectorPipelines;
  * quickstart_serve: `--random-tiny --device cpu` prints one block an
    image; its function on a tiny fp32 model gives each image the port's
    greedy generate_im2svg text.
"""

import contextlib
import io
import json
import os
import runpy
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
TIMING_KEYS = {"rollout_s", "reward_s", "update_s"}


def _grpo_argv(out_dir) -> list[str]:
    return ["config=configs/models/starvector-1b/im2svg-grpo.yaml", "model.preset=tiny",
            "model.image_size=28",
            "data.train.target=starvector_tpu.data.datasets.ToySVGDataset",
            "data.train.params.im_size=28", "data.batch_size=2", "grpo.num_generations=2",
            "grpo.max_new_tokens=4", "grpo.reward_resolution=32", "grpo.steps=2",
            "training.checkpointing_steps=1", "training.checkpoints_total_limit=1",
            f"project.out_dir={out_dir}"]


def _stand_in(raw_svgs, targets, *, num_generations, **kw):
    return np.linspace(0.0, 1.0, len(raw_svgs), dtype=np.float32)


def _logged(out_dir) -> list[dict]:
    return [r for r in map(json.loads, open(Path(out_dir) / "metrics.jsonl")) if "loss" in r]


def test_grpo_driver_runs_as_the_jax_script(tmp_path, monkeypatch):
    from starvector_tpu.train import grpo as jgrpo
    from starvector_tpu_torch.config import get_config
    from starvector_tpu_torch.train import grpo as tgrpo

    monkeypatch.setattr(jgrpo, "batch_rewards", _stand_in)
    monkeypatch.setattr(tgrpo, "batch_rewards", _stand_in)
    monkeypatch.setenv("STARVECTOR_COMPILE_CACHE", "0")  # the JAX script's cache: off
    monkeypatch.chdir(REPO)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    monkeypatch.setattr(sys, "argv", ["train_grpo.py", *_grpo_argv(jdir)])
    with contextlib.redirect_stdout(io.StringIO()) as jout:
        runpy.run_path(str(REPO / "scripts" / "train_grpo.py"), run_name="__main__")
    with contextlib.redirect_stdout(io.StringIO()) as tout:
        model, records = tgrpo.main(get_config(_grpo_argv(tdir) + ["training.device=cpu"]))
    ref, port = _logged(jdir), _logged(tdir)
    assert [r["step"] for r in port] == [r["step"] for r in ref] == [1, 2]
    for p, r in zip(port, ref):
        assert set(p) - TIMING_KEYS == set(r), (sorted(p), sorted(r))
        assert TIMING_KEYS <= set(p)
    assert records == port
    names = lambda d: sorted(n for n in os.listdir(d) if n.startswith("checkpoint-"))  # noqa: E731
    assert names(tdir) == names(jdir) == ["checkpoint-2"]
    # the printed lines: one a step, the same words
    for out in (jout.getvalue(), tout.getvalue()):
        steps = [line.split(":")[0] for line in out.splitlines() if line.startswith("step ")]
        assert steps == ["step 1", "step 2"], out
    from starvector_tpu_torch.train.checkpoint import restore_checkpoint

    saved = restore_checkpoint(str(tdir / "checkpoint-2"))["params"]
    assert torch.equal(saved["svg_transformer"]["wte"],
                       model.params["svg_transformer"]["wte"].detach())


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A tiny 1B exported by the JAX package (train/hub.py on
    models/export.py), decoder projections scaled by 10 so that greedy
    decoding does not echo one token; and a 56-px PNG."""
    from PIL import Image

    from starvector_tpu.models import starvector as jsv
    from starvector_tpu.models.tokenizer import build_test_tokenizer
    from starvector_tpu.train.hub import export_hf_checkpoint

    root = tmp_path_factory.mktemp("quickstart")
    cfg = jsv.tiny_config(image_size=56)
    tree = jax.tree_util.tree_map(np.asarray, jsv.init_params(cfg, jax.random.PRNGKey(0)))
    for grp in tree["svg_transformer"]["layers"]["attn"], tree["svg_transformer"]["layers"]["mlp"]:
        for p in grp.values():
            p["kernel"] = p["kernel"] * 10.0
    export_hf_checkpoint(tree, cfg, build_test_tokenizer("v1"), str(root / "ckpt"))
    rng = np.random.default_rng(3)
    paths = []
    for i, shape in enumerate(((40, 56, 3), (56, 56, 3))):
        path = root / f"image{i}.png"
        Image.fromarray(rng.integers(0, 256, shape, dtype=np.uint8)).save(path)
        paths.append(str(path))
    return str(root / "ckpt"), paths


def _printed(fn) -> str:
    with contextlib.redirect_stdout(io.StringIO()) as out:
        fn()
    return out.getvalue()


def test_quickstart_prints_the_jax_scripts_svg(checkpoint, monkeypatch):
    from PIL import Image

    from starvector_tpu.api import StarVectorForCausalLM as JModel, StarVectorPipeline as JPipe
    from starvector_tpu_torch import quickstart
    from starvector_tpu_torch.api import StarVectorForCausalLM as TModel, StarVectorPipeline as TPipe

    ckpt, (image, _) = checkpoint
    monkeypatch.setattr(sys, "argv", ["quickstart.py", ckpt, image, "16"])
    ref = _printed(lambda: runpy.run_path(str(REPO / "scripts" / "quickstart.py"),
                                          run_name="__main__"))
    out = _printed(lambda: quickstart.main([ckpt, image, "16", "--device", "cpu"]))
    assert out == ref and out.startswith("<svg")
    # fp32: the same raw text before the SVG clean-up
    kw = dict(max_new_tokens=16, use_nucleus_sampling=False)
    jraw = JPipe(JModel.from_pretrained(ckpt, dtype=jax.numpy.float32))(Image.open(image), **kw)
    traw = TPipe(TModel.from_pretrained(ckpt, dtype=torch.float32, device="cpu"))(
        Image.open(image), **kw)
    assert traw["raw_svg"] == jraw["raw_svg"] and traw["svg"] == jraw["svg"]
    assert len(set(traw["raw_svg"][4:])) >= 3, traw["raw_svg"]


def test_quickstart_serve_random_tiny_prints_a_block_an_image(checkpoint):
    from starvector_tpu_torch import quickstart_serve

    _, paths = checkpoint
    out = _printed(lambda: quickstart_serve.main(["--random-tiny", *paths, "--device", "cpu"]))
    lines = out.splitlines()
    assert [line for line in lines if line.startswith("===")] == [f"=== {p} ===" for p in paths]
    assert all(lines[i + 1].startswith("<svg") for i, line in enumerate(lines)
               if line.startswith("==="))


def test_quickstart_serve_gives_the_apis_greedy_text(checkpoint):
    from PIL import Image

    from starvector_tpu_torch.api import StarVectorForCausalLM
    from starvector_tpu_torch.quickstart_serve import serve_images

    ckpt, paths = checkpoint
    model = StarVectorForCausalLM.from_pretrained(ckpt, dtype=torch.float32, device="cpu")
    texts, stats = serve_images(model, paths, 16)
    ref = [model.generate_im2svg({"image": model.process_images([Image.open(p)])},
                                 max_new_tokens=16, use_nucleus_sampling=False)[0] for p in paths]
    assert texts == ref
    assert stats["admissions"] == len(paths) and stats["prefill_chunks"] >= 1
