"""Checkpoints out and back in, the builder and the API's loss and
pipeline, against starvector_tpu:

  * models/export.py + train/hub.py: the port's export loads in the JAX
    package's load_hf_starvector_checkpoint with the same parameters (bit
    for bit, fp32) and config; the JAX export loads in the port's
    builder.load_pretrained_model with the same parameters, config and
    context_len; both write the same config.json, key for key. For a tiny
    1B (GPTBigCode, CLIP, BatchNorm adapter with running statistics) and a
    tiny 8B (StarCoder2 with an untied head, SigLIP, LayerNorm adapter).
  * models/builder.py::config_from_yaml_block equals the JAX one on every
    yaml under configs/models/, and utils/experiment.py's experiment id
    equals the JAX one on the configs those yamls make.
  * api.py: forward gives the JAX forward's loss (1e-5 relative, fp32);
    StarVectorPipeline gives the JAX pipeline's raw_svg (greedy, exact).
  * train/hub.py::push_model_to_hub calls the Hub client with the folder and
    repo id (a stand-in HfApi: no network).
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starvector_tpu.models import builder as jbuilder
from starvector_tpu.models import gpt_bigcode as jgbc
from starvector_tpu.models import starcoder2 as jsc
from starvector_tpu.models import starvector as jsv
from starvector_tpu.models.vision import siglip as jsig
from starvector_tpu.ops.layers import DTypePolicy as JPolicy
from starvector_tpu_torch.models import builder as tbuilder
from starvector_tpu_torch.models import convert
from starvector_tpu_torch.ops.layers import DTypePolicy as TPolicy

REPO = Path(__file__).resolve().parents[1]
YAMLS = sorted((REPO / "configs" / "models").rglob("*.yaml"))
MAX_LENGTH = 1024  # unlike either preset's (8192, 16000) and the tiny one's (128)


def _model(kind: str):
    """(JAX config, numpy tree): the tiny 1B or the tiny 8B-shaped model."""
    if kind == "1b":
        cfg = jsv.tiny_config(image_size=56, adapter_norm="batch_norm", max_length_train=MAX_LENGTH,
                              llm=jgbc.tiny_config(attn_impl="mixed"))
        tree = jax.tree_util.tree_map(np.asarray, jsv.init_params(cfg, jax.random.PRNGKey(0)))
        rng = np.random.default_rng(0)
        norm = tree["image_projection"]["norm"]
        norm["running_mean"] = rng.standard_normal(norm["running_mean"].shape).astype(np.float32)
        norm["running_var"] = (1 + rng.random(norm["running_var"].shape)).astype(np.float32)
        return cfg, tree
    cfg = jsv.tiny_config(
        decoder="starcoder2", image_encoder_type="siglip_384", image_size=32,
        adapter_norm="layer_norm", vision_tower=jsig.tiny_config(), max_length_train=MAX_LENGTH,
        llm=jsc.tiny_config(vocab_size=517, rope_theta=5e5, sliding_window=16,
                            tie_word_embeddings=False, max_position_embeddings=16384))
    return cfg, jax.tree_util.tree_map(np.asarray, jsv.init_params(cfg, jax.random.PRNGKey(3)))


def _version(cfg) -> str:
    return "v2" if cfg.decoder == "starcoder2" else "v1"


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _assert_same_tree(got, ref):
    got, ref = dict(_leaves(got)), dict(_leaves(ref))
    assert got.keys() == ref.keys()
    for k, v in ref.items():
        g = got[k]
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_array_equal(g, np.asarray(v), err_msg=k)


def _assert_same_config(tcfg, jcfg):
    """Every field the port's StarVectorConfig, decoder and tower configs
    have equals the JAX one's (the port has no attn_impl or use_cache)."""
    for f in dataclasses.fields(tcfg):
        if f.name in ("llm", "vision_tower"):
            t, j = getattr(tcfg, f.name), getattr(jcfg, f.name)
            assert (t is None) == (j is None), f.name
            if t is not None:
                for g in dataclasses.fields(t):
                    assert getattr(t, g.name) == getattr(j, g.name), (f.name, g.name)
        else:
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name


@pytest.mark.parametrize("kind", ["1b", "8b"])
def test_port_export_loads_in_the_jax_package(kind, tmp_path):
    """The port's export_hf_checkpoint -> the JAX loader: the exported
    model's parameters bit for bit (fp32) and the config the JAX package
    reads from its own export of the same model; both config.json files
    equal key for key."""
    from starvector_tpu.models.tokenizer import build_test_tokenizer as jtok
    from starvector_tpu.train.hub import export_hf_checkpoint as jexport
    from starvector_tpu_torch.models.tokenizer import build_test_tokenizer
    from starvector_tpu_torch.train.hub import export_hf_checkpoint

    jcfg, tree = _model(kind)
    tcfg = tbuilder.load_hf_starvector_checkpoint(
        jexport(tree, jcfg, jtok(_version(jcfg)), str(tmp_path / "jax")), torch.float32,
        device="cpu")[1]
    export_hf_checkpoint(convert.from_jax_params(tree), tcfg,
                         build_test_tokenizer(_version(tcfg)), str(tmp_path / "port"))
    got, got_cfg, got_tok = jbuilder.load_hf_starvector_checkpoint(str(tmp_path / "port"),
                                                                   jnp.float32)
    _, ref_cfg, _ = jbuilder.load_hf_starvector_checkpoint(str(tmp_path / "jax"), jnp.float32)
    _assert_same_tree(jax.tree_util.tree_map(np.asarray, got), tree)
    assert got_cfg == ref_cfg and got_cfg.max_length_train == MAX_LENGTH
    assert got_tok.version == _version(jcfg)
    port_json, jax_json = (json.loads((tmp_path / d / "config.json").read_text())
                           for d in ("port", "jax"))
    assert port_json == jax_json
    assert (tmp_path / "port" / "tokenizer.json").exists()


@pytest.mark.parametrize("kind", ["1b", "8b"])
def test_jax_export_loads_through_load_pretrained_model(kind, tmp_path):
    """The JAX export_hf_checkpoint -> builder.load_pretrained_model: the
    from_jax_params tree bit for bit (fp32), the JAX loader's config, the
    decoder's tokenizer, the tower's processor, and context_len =
    max_length_train (the value config_from_hf lost before its repair)."""
    from starvector_tpu.models.tokenizer import build_test_tokenizer as jtok
    from starvector_tpu.train.hub import export_hf_checkpoint as jexport

    jcfg, tree = _model(kind)
    path = jexport(tree, jcfg, jtok(_version(jcfg)), str(tmp_path))
    params, cfg, tok, processor, context_len = tbuilder.load_pretrained_model(
        path, torch.float32, device="cpu")
    _assert_same_tree(params, tree)
    _assert_same_config(cfg, jbuilder.load_hf_starvector_checkpoint(path, jnp.float32)[1])
    assert context_len == cfg.max_length_train == MAX_LENGTH
    assert tok.version == _version(jcfg)
    assert processor(np.zeros((10, 12, 3), np.uint8)).shape == (jcfg.image_size,) * 2 + (3,)


@pytest.mark.parametrize("path", YAMLS, ids=lambda p: str(p.relative_to(REPO / "configs")))
def test_config_from_yaml_block_matches_jax(path):
    from starvector_tpu_torch.config import load_yaml

    block = dict(load_yaml(path).get("model") or {})
    _assert_same_config(tbuilder.config_from_yaml_block(block),
                        jbuilder.config_from_yaml_block(block))


def test_experiment_id_matches_jax():
    """The same md5 for the config each yaml makes (default.yaml, the yaml,
    a dotlist override), in both packages."""
    from starvector_tpu.config import get_config as jget
    from starvector_tpu.utils.experiment import generate_experiment_id as jid
    from starvector_tpu_torch.config import get_config as tget
    from starvector_tpu_torch.utils.experiment import generate_experiment_id as tid

    default = str(REPO / "configs" / "models" / "default.yaml")
    ids = set()
    for path in YAMLS:
        argv = [f"config={path}", "training.lr=3e-4"]
        got = tid(tget(argv, default_path=default))
        assert got == jid(jget(argv, default_path=default)), path
        ids.add(got)
    assert len(ids) == len(YAMLS)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    B, S = 2, 10
    mask = (np.arange(S)[None, :] < np.array([[10], [6]])).astype(np.int32)
    ids = np.where(mask > 0, rng.integers(1, cfg.llm.vocab_size, (B, S)), 0).astype(np.int32)
    img = rng.standard_normal((B, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    return {"image": img, "svg_ids": ids, "svg_mask": mask}


@pytest.mark.parametrize("kind", ["1b", "8b"])
def test_forward_matches_jax(kind, tmp_path):
    """StarVectorForCausalLM.forward(batch), the loss with the adapter's
    running statistics, against the JAX API's forward, each package's
    from_pretrained on the JAX export at an fp32 policy (1e-5)."""
    from starvector_tpu.api import StarVectorForCausalLM as JModel
    from starvector_tpu.models.tokenizer import build_test_tokenizer as jtok
    from starvector_tpu.train.hub import export_hf_checkpoint as jexport
    from starvector_tpu_torch.api import StarVectorForCausalLM

    jcfg, tree = _model(kind)
    path = jexport(tree, jcfg, jtok(_version(jcfg)), str(tmp_path))
    batch = _batch(jcfg)
    jm = JModel.from_pretrained(path, jnp.float32)
    jm.policy = JPolicy(param_dtype=jnp.float32, compute_dtype=jnp.float32)
    ref = jm.forward({k: jnp.asarray(v) for k, v in batch.items()})
    model = StarVectorForCausalLM.from_pretrained(path, torch.float32, device="cpu")
    model.policy = TPolicy(param_dtype=torch.float32, compute_dtype=torch.float32)
    with torch.no_grad():
        loss = model.forward(batch)
    assert float(loss) == pytest.approx(float(ref), rel=1e-5)


def test_pipeline_matches_jax(tmp_path):
    """StarVectorPipeline on a tiny greedy 1B (exported by the JAX package,
    loaded by each package's from_pretrained at fp32): the JAX pipeline's
    raw_svg, and an svg string and a raster out."""
    from PIL import Image

    from starvector_tpu.api import StarVectorForCausalLM as JModel
    from starvector_tpu.api import StarVectorPipeline as JPipeline
    from starvector_tpu.models.tokenizer import build_test_tokenizer as jtok
    from starvector_tpu.train.hub import export_hf_checkpoint as jexport
    from starvector_tpu_torch.api import StarVectorForCausalLM, StarVectorPipeline

    jcfg, tree = _model("1b")
    for grp in tree["svg_transformer"]["layers"]["attn"], tree["svg_transformer"]["layers"]["mlp"]:
        for p in grp.values():
            p["kernel"] = p["kernel"] * 10.0  # confident logits: no near-ties in greedy
    path = jexport(tree, jcfg, jtok("v1"), str(tmp_path))
    image = Image.fromarray(np.random.default_rng(2).integers(0, 256, (40, 56, 3), np.uint8))
    kw = dict(max_length=12, use_nucleus_sampling=False)
    jm = JModel.from_pretrained(path, jnp.float32)
    jm.policy = JPolicy(param_dtype=jnp.float32, compute_dtype=jnp.float32)
    ref = JPipeline(jm)(image, **kw)
    tm = StarVectorForCausalLM.from_pretrained(path, torch.float32, device="cpu")
    tm.policy = TPolicy(param_dtype=torch.float32, compute_dtype=torch.float32)
    out = StarVectorPipeline(tm)(image, **kw)
    assert out["raw_svg"] == ref["raw_svg"] and out["raw_svg"].startswith("<svg")
    assert isinstance(out["svg"], str) and np.asarray(out["raster"]).ndim == 3


def test_push_model_to_hub_uploads_the_folder(tmp_path, monkeypatch):
    """push_model_to_hub creates the repo and uploads the folder through
    huggingface_hub.HfApi (a stand-in here), and returns the repo's URL."""
    import huggingface_hub

    from starvector_tpu_torch.train.hub import push_model_to_hub

    calls = []

    class StandIn:
        def __init__(self, token=None):
            calls.append(("init", token))

        def create_repo(self, repo_id, private, exist_ok):
            calls.append(("create_repo", repo_id, private, exist_ok))

        def upload_folder(self, folder_path, repo_id, commit_message):
            calls.append(("upload_folder", folder_path, repo_id, commit_message))

    monkeypatch.setattr(huggingface_hub, "HfApi", StandIn)
    url = push_model_to_hub("me/starvector-ft", str(tmp_path / "ckpt"), token="t")
    assert url == "https://huggingface.co/me/starvector-ft"
    assert calls == [("init", "t"), ("create_repo", "me/starvector-ft", True, True),
                     ("upload_folder", str(tmp_path / "ckpt"), "me/starvector-ft",
                      "upload ckpt")]
