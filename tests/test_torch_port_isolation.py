"""The port stands alone: no module of starvector_tpu_torch, and not
chip_smoke.py, imports jax or the JAX package; its training entry point and
from_pretrained run with neither in sys.modules, its serving stack (the web
UI too) without aiohttp or requests either, and its eval harness without
pandas or requests; its entry points (the quickstarts, the GRPO driver and
the web UI among them) run on the card unless asked for the CPU; and its
own copies of the JAX package's config, tokenizer, dataset and loader
modules give the JAX loader's batch.

The run that checks sys.modules is a subprocess: this test process has
imported jax (tests/conftest.py)."""

import ast
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "starvector_tpu")


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_sources_import_nothing_of_jax():
    files = sorted((REPO / "starvector_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 35
    bad = [(str(f.relative_to(REPO)), m) for f in files for m in _imported_modules(f)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad


def test_training_and_from_pretrained_leave_jax_out(tmp_path):
    """The verify skill's CPU training command (a config whose dataset
    targets name starvector_tpu.data.*), 2 steps, then from_pretrained
    (quantize=True) on a tiny HF-layout checkpoint and a short im2svg and
    text2svg generation, beam search and speculative decoding, then one
    GRPOTrainer step on the fp32 checkpoint and generate_pipelined and
    generate_pipelined_spec over two batches, in one fresh process: neither
    jax nor starvector_tpu gets imported."""
    import jax

    from starvector_tpu.models import starvector as jsv
    from starvector_tpu.models.tokenizer import build_test_tokenizer
    from starvector_tpu.train.hub import export_hf_checkpoint

    cfg = jsv.tiny_config(image_size=56)
    tree = jax.tree_util.tree_map(np.asarray, jsv.init_params(cfg, jax.random.PRNGKey(0)))
    ckpt, run = tmp_path / "ckpt", tmp_path / "run"
    export_hf_checkpoint(tree, cfg, build_test_tokenizer("v1"), str(ckpt))
    code = textwrap.dedent(f"""
        import sys
        import numpy as np
        import torch
        from starvector_tpu_torch.train.train import main_cli
        sys.argv = ["train", "config=configs/models/starvector-1b/im2svg-icons.yaml",
                    "model.preset=tiny", "model.image_size=28",
                    "data.train.target=starvector_tpu.data.datasets.ToySVGDataset",
                    "data.train.params.im_size=28", "data.val=null", "data.batch_size=2",
                    "data.num_workers=1", "training.steps=2", "training.bf16=false",
                    "training.device=cpu", "project.out_dir={run}"]
        main_cli()
        from starvector_tpu_torch.api import StarVectorForCausalLM
        model = StarVectorForCausalLM.from_pretrained({str(ckpt)!r}, dtype=torch.float32,
                                                      device="cpu", quantize=True)
        img = np.random.default_rng(0).integers(0, 256, (40, 56, 3), dtype=np.uint8)
        text = model.generate_im2svg({{"image": model.process_images([img])}}, max_length=4,
                                     use_nucleus_sampling=False)
        assert text[0].startswith("<svg"), text
        text = model.generate_text2svg({{"caption": ["a red circle", "a star"]}},
                                       max_new_tokens=4, use_nucleus_sampling=False)
        assert len(text) == 2, text
        batch = {{"image": model.process_images([img, img[::-1].copy()])}}
        for route in (dict(num_beams=2), dict(use_speculative=True, draft_len=3)):
            text = model.generate_im2svg(batch, max_length=5, use_nucleus_sampling=False, **route)
            assert len(text) == 2 and text[0].startswith("<svg"), (route, text)
        from starvector_tpu_torch.train.grpo import GRPOConfig, GRPOTrainer
        model = StarVectorForCausalLM.from_pretrained({str(ckpt)!r}, dtype=torch.float32,
                                                      device="cpu")
        trainer = GRPOTrainer(model, GRPOConfig(num_generations=2, max_new_tokens=4,
                                                reward_resolution=32))
        out = trainer.step(batch["image"], [np.zeros((32, 32, 3), np.uint8)] * 2)
        assert out["step"] == 1 and np.isfinite(out["loss"]), out
        from starvector_tpu_torch.generation import engine, speculative
        dec, llm = model.params["svg_transformer"], model.cfg.llm
        ids = torch.tensor([[3, 1, 4, 1, 5], [9, 2, 6, 5, 3]])
        stream = [(dec["wte"][ids], torch.ones(ids.shape, dtype=torch.int32), ids)] * 2
        gen = engine.GenerationConfig(max_new_tokens=3, do_sample=False)
        for out in (engine.generate_pipelined(dec, llm, [b[:2] for b in stream], gen),
                    speculative.generate_pipelined_spec(dec, llm, stream, gen, draft_len=3)):
            assert len(out) == 2 and out[1][0].shape == (2, 3), out
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r})
        assert not leaked, leaked
        print("clean")
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("clean"), proc.stderr[-4000:]
    steps = [json.loads(line)["step"] for line in open(run / "metrics.jsonl")
             if "loss" in json.loads(line)]
    assert steps == [2]  # log_every 10: the last step logs
    assert (run / "checkpoint-2").is_dir()


def test_export_and_load_pretrained_leave_jax_out(tmp_path):
    """The checkpoint round trip in one fresh process: a tiny 8B-shaped
    model's export_hf_checkpoint, then builder.load_pretrained_model and
    the Adafactor / bf16-gradient step on what it loaded; neither jax nor
    starvector_tpu gets imported."""
    code = textwrap.dedent(f"""
        import sys
        import torch
        from starvector_tpu_torch.models import builder, starvector as sv
        from starvector_tpu_torch.models.tokenizer import build_test_tokenizer
        from starvector_tpu_torch.ops.layers import DTypePolicy
        from starvector_tpu_torch.train.hub import export_hf_checkpoint
        from starvector_tpu_torch.train.optim import build_optimizer
        from starvector_tpu_torch.train.step import make_train_step, mark_trainable
        cfg = sv.tiny_config(decoder="starcoder2", adapter_norm="layer_norm")
        params = sv.init_params(cfg, torch.Generator().manual_seed(0))
        export_hf_checkpoint(params, cfg, build_test_tokenizer("v2"), {str(tmp_path)!r})
        params, cfg, tok, processor, n = builder.load_pretrained_model(
            {str(tmp_path)!r}, torch.float32, device="cpu")
        assert n == cfg.max_length_train and tok.version == "v2"
        mark_trainable(params)
        opt = build_optimizer(params, optimizer="adafactor")
        step = make_train_step(cfg, opt, tok.pad_token_id, policy=DTypePolicy(),
                               remat="dots_slim", grad_dtype=torch.bfloat16)
        batch = {{"image": torch.zeros(1, 28, 28, 3), "svg_ids": torch.ones(1, 8).long(),
                  "svg_mask": torch.ones(1, 8, dtype=torch.int32)}}
        step(params, opt.init(params), batch)
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r})
        assert not leaked, leaked
        print("clean")
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("clean"), proc.stderr[-4000:]
    assert (tmp_path / "model.safetensors").exists() and (tmp_path / "config.json").exists()


def test_entry_points_refuse_to_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the entry points' default runs there")
    from starvector_tpu_torch.api import StarVectorForCausalLM
    from starvector_tpu_torch.config import ConfigNode
    from starvector_tpu_torch.models import starvector as tsv
    from starvector_tpu_torch.models.builder import load_pretrained_model
    from starvector_tpu_torch.train.train import main

    cfg = tsv.tiny_config(image_size=56)
    for call in (lambda: StarVectorForCausalLM({}, cfg),
                 lambda: StarVectorForCausalLM.from_config(cfg),
                 lambda: StarVectorForCausalLM.from_pretrained(str(tmp_path)),
                 lambda: load_pretrained_model(str(tmp_path))):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    with pytest.raises(RuntimeError, match="training.device=cpu"):
        main(ConfigNode({"project": {"out_dir": str(tmp_path / "run")},
                         "model": {"preset": "tiny"}}))
    assert not (tmp_path / "run").exists()
    # serving: the engine, and the worker's and controller's main
    from starvector_tpu_torch.models import gpt_bigcode as tgbc
    from starvector_tpu_torch.serve import controller, worker
    from starvector_tpu_torch.serve.engine import ServeEngine

    params = tgbc.init_params(tgbc.tiny_config(), torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ServeEngine(params, tgbc.tiny_config(), "gpt_bigcode", max_batch=1, max_len=16)
    for entry, argv in ((worker.main, ["--model-path", str(tmp_path), "--port", "0"]),
                        (controller.main, ["--port", "0"])):
        with pytest.raises(RuntimeError, match="--device cpu"):
            entry(argv)
    # the quickstarts, the web UI and the GRPO driver
    from starvector_tpu_torch import quickstart, quickstart_serve
    from starvector_tpu_torch.serve import webui
    from starvector_tpu_torch.train import grpo

    for entry, argv in ((quickstart.main, ["--random-tiny", str(tmp_path / "x.png")]),
                        (quickstart_serve.main, ["--random-tiny", str(tmp_path / "x.png")]),
                        (webui.main, ["--port", "0", "--log-dir", str(tmp_path / "votes")])):
        with pytest.raises(RuntimeError, match="--device cpu"):
            entry(argv)
    assert not (tmp_path / "votes").exists()
    with pytest.raises(RuntimeError, match="training.device=cpu"):
        grpo.main(ConfigNode({"project": {"out_dir": str(tmp_path / "grpo")},
                              "model": {"preset": "tiny"}}))
    assert not (tmp_path / "grpo").exists()


def test_serving_leaves_jax_aiohttp_and_requests_out(tmp_path):
    """The port's worker and controller modules, a tiny engine on the CPU
    serving one greedy request, the worker's, controller's and web UI's HTTP
    servers, and the quickstart_serve and GRPO driver modules, in one fresh
    process: neither jax, the JAX package, aiohttp nor requests gets
    imported."""
    code = textwrap.dedent(f"""
        import sys
        import torch
        from starvector_tpu_torch.api import StarVectorForCausalLM
        from starvector_tpu_torch.models import starvector as sv
        from starvector_tpu_torch.models.tokenizer import build_test_tokenizer
        from starvector_tpu_torch.serve import controller, worker
        from starvector_tpu_torch.serve.engine import Request
        model = StarVectorForCausalLM.from_config(sv.tiny_config(), tokenizer=build_test_tokenizer(),
                                                  device="cpu")
        w = worker.ModelWorker(model, worker_addr="http://w", max_batch=2, max_len=64)
        emb = model.params["svg_transformer"]["wte"][torch.tensor([[3, 1, 4]])]
        out = w.engine.generate_sync(Request(prefix_embeds=emb, max_new_tokens=3,
                                             do_sample=False), timeout=120)
        assert len(out) == 3, out
        from starvector_tpu_torch.serve import webui
        for srv in (worker.build_server(w), controller.build_server(controller.Controller()),
                    webui.build_server("http://w", {str(tmp_path / "votes")!r})):
            srv.server_close()
        import starvector_tpu_torch.quickstart_serve, starvector_tpu_torch.train.grpo  # noqa: F401
        w.shutdown()
        leaked = sorted(m for m in sys.modules
                        if m.split(".")[0] in {FORBIDDEN + ("aiohttp", "requests")!r})
        assert not leaked, leaked
        print("clean")
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("clean"), proc.stderr[-4000:]


def test_eval_harness_leaves_jax_pandas_and_requests_out(tmp_path):
    """The validator CLI's path in one fresh process: get_validator on the
    repo's configs/generation/jax/starvector-1b/im2svg.yaml (engine "jax",
    dataset target starvector_tpu.data.datasets.SVGDataset) with a tiny
    checkpoint and a local jsonl split, validate() on the CPU with LPIPS
    and FID on narrow random weights beside the pixel metrics; without
    model.device=cpu the CLI refuses to run where no card is visible.
    Neither jax, the JAX package, pandas nor requests gets imported."""
    code = textwrap.dedent(f"""
        import json, os, sys
        import torch
        from starvector_tpu_torch.config import get_config
        from starvector_tpu_torch.metrics import inception_v3, lpips_vgg
        from starvector_tpu_torch.models import starvector as sv
        from starvector_tpu_torch.models.tokenizer import build_test_tokenizer
        from starvector_tpu_torch.train.hub import export_hf_checkpoint
        from starvector_tpu_torch.validation.parity_samples import SAMPLES
        from starvector_tpu_torch.validation.validate import get_validator
        tmp = {str(tmp_path)!r}
        cfg = sv.tiny_config()
        export_hf_checkpoint(sv.init_params(cfg, torch.Generator().manual_seed(0)), cfg,
                             build_test_tokenizer("v1"), tmp + "/ckpt")
        os.makedirs(tmp + "/data")
        with open(tmp + "/data/test.jsonl", "w") as f:
            for sid, svg in SAMPLES[:2]:
                f.write(json.dumps({{"Svg": svg, "Filename": sid + ".svg"}}) + "\\n")
        for d in ("lpips-vgg", "inception"):
            os.makedirs(f"{{tmp}}/weights/{{d}}")
        vgg, lin = lpips_vgg.random_state_dicts(0, (8, 16, 32, 64, 64))
        torch.save(vgg, tmp + "/weights/lpips-vgg/vgg16.pth")
        torch.save(lin, tmp + "/weights/lpips-vgg/lpips_vgg.pth")
        torch.save(inception_v3.random_state_dict(0, divisor=16),
                   tmp + "/weights/inception/inception_v3.pth")
        os.environ["STARVECTOR_METRICS_DIR"] = tmp + "/weights"
        argv = ["config=configs/generation/jax/starvector-1b/im2svg.yaml",
                "model.from_checkpoint=" + tmp + "/ckpt", "run.out_dir=" + tmp + "/eval",
                "dataset.params.dataset_name=" + tmp + "/data", "dataset.params.im_size=28",
                "generation_params.max_new_tokens=4", "generation_params.temperature=0.0",
                "metrics.L2=true", "metrics.SSIM=true", "metrics.CountTokenLength=true",
                "metrics.LPIPS=true", "metrics.FID=true"]
        if not torch.cuda.is_available():
            try:
                get_validator(get_config(argv))
                raise AssertionError("the validator ran without a card")
            except RuntimeError as e:
                assert "model.device=cpu" in str(e), e
        v = get_validator(get_config(argv + ["model.device=cpu"]))
        assert type(v).__name__ == "StarVectorTorchValidator"
        assert type(v.model).__module__ == "starvector_tpu_torch.api"
        avg, per = v.validate()
        assert set(avg) == {{"L2", "SSIM", "LPIPS", "FID", "CountTokenLength",
                             "ratio_post_processed", "ratio_non_compiling"}}, avg
        assert len(per) == 2 and all(v == v for v in avg.values()), avg
        assert os.path.exists(os.path.join(v.out_dir, "results", "all_results.csv"))
        leaked = sorted(m for m in sys.modules
                        if m.split(".")[0] in {FORBIDDEN + ("pandas", "requests")!r})
        assert not leaked, leaked
        print("clean")
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("clean"), \
        proc.stdout[-2000:] + proc.stderr[-4000:]


def test_config_targets_map_to_the_port():
    from starvector_tpu_torch.config import get_obj_from_str, port_target
    from starvector_tpu_torch.data.datasets import SVGIconsDataset

    assert port_target("starvector_tpu.data.datasets.SVGIconsDataset") == \
        "starvector_tpu_torch.data.datasets.SVGIconsDataset"
    assert get_obj_from_str("starvector_tpu.data.datasets.SVGIconsDataset") is SVGIconsDataset
    assert port_target("numpy.zeros") == "numpy.zeros"
    with pytest.raises(ValueError, match="starvector_tpu.models.starvector.StarVectorConfig"):
        get_obj_from_str("starvector_tpu.models.starvector.StarVectorConfig")


def test_loader_batch_equals_the_jax_loaders():
    """The first batch of each loader over ToySVGDataset (seed 3): ids,
    masks, captions and ids equal; images equal to fp32 rounding (atol
    1e-6): the JAX package resizes with PIL and the port with torch, and at
    the render's own size both are the identity."""
    from starvector_tpu.data.datasets import ToySVGDataset as JToy
    from starvector_tpu.models.tokenizer import build_test_tokenizer as jtokenizer
    from starvector_tpu.train.loader import DataLoader as JLoader
    from starvector_tpu_torch.data.datasets import ToySVGDataset as TToy
    from starvector_tpu_torch.models.tokenizer import build_test_tokenizer as ttokenizer
    from starvector_tpu_torch.train.loader import DataLoader as TLoader

    kw = dict(max_length=64, num_workers=1, seed=3, process_index=0, process_count=1)
    ref = next(iter(JLoader(JToy(num_samples=6, im_size=28), jtokenizer(), 2, **kw)))
    out = next(iter(TLoader(TToy(num_samples=6, im_size=28), ttokenizer(), 2, **kw)))
    assert out["id"] == ref["id"] and out["caption"] == ref["caption"]
    for key in ("svg_ids", "svg_mask"):
        assert out[key].dtype == ref[key].dtype
        np.testing.assert_array_equal(out[key], ref[key])
    assert out["image"].dtype == np.float32 and out["image"].shape == ref["image"].shape
    np.testing.assert_allclose(out["image"], ref["image"], rtol=0, atol=1e-6)
