"""The port's eval harness (starvector_tpu_torch/validation/) against the
JAX package's, on the CPU: the in-process validator end to end on the same
tiny weights (the JAX params carried over with models/convert.py), the same
in-memory dataset of 4 probe SVGs, B = 2, 8 greedy tokens: texts, flags,
per-sample files, results_avg.json (1e-6), all_results.csv and the sink's
jsonl equal the JAX validator's. Also the post-process chain, the engine
map and registry, a config's JAX dataset target, the temperature sweep's
layout, the REST validator against the port's worker and controller on
127.0.0.1, the metrics sink and plots, the results CSV against pandas, and
the rasterizer's fallbacks without librsvg/cairo (no worker process)."""

import csv
import inspect
import json
import os
import re
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from starvector_tpu.api import StarVectorForCausalLM as JModel
from starvector_tpu.config import ConfigNode as JNode
from starvector_tpu.models import starvector as jsv
from starvector_tpu.validation.jax_validator import StarVectorJAXValidator
from starvector_tpu_torch.api import StarVectorForCausalLM
from starvector_tpu_torch.config import ConfigNode
from starvector_tpu_torch.data import rasterize as rz
from starvector_tpu_torch.models import convert
from starvector_tpu_torch.models import starvector as tsv
from starvector_tpu_torch.models.tokenizer import build_test_tokenizer
from starvector_tpu_torch.ops.layers import DTypePolicy
from starvector_tpu_torch.validation import validate as vcli
from starvector_tpu_torch.validation.parity_samples import SAMPLES
from starvector_tpu_torch.validation.serve_validator import StarVectorServeValidator
from starvector_tpu_torch.validation.svg_validator_base import (
    validator_registry, write_results_csv,
)
from starvector_tpu_torch.validation.torch_validator import StarVectorTorchValidator

needs_native = pytest.mark.skipif(not rz.rasterizer_available(),
                                  reason="librsvg/cairo unavailable")
REPO = Path(__file__).resolve().parents[1]
FILES = (".svg", "_raw.svg", "_gt.svg", "_generated.png", "_original.png", "/metadata.json")
METRICS = {"L2": True, "Masked-L2": True, "SSIM": True, "CountTokenLength": True,
           "ratio_post_processed": True, "ratio_non_compiling": True}


class _MemDataset:
    """The dataset contract without rasterizing: processed images from a
    seed, the probe SVGs as ground truth, and PIL images for the REST
    validator."""

    def __init__(self, n, im_size):
        self.n = n
        self.im_size = im_size

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.RandomState(i)
        return {
            "image": rng.randn(self.im_size, self.im_size, 3).astype(np.float32),
            "image_pil": Image.fromarray(rng.randint(0, 256, (36, 30, 3), np.uint8)),
            "svg": SAMPLES[i][1],
            "id": f"{SAMPLES[i][0]}.svg",
            "caption": f"probe {i}",
        }


def _config(out_dir, engine="jax", n=4, **extra):
    cfg = {
        "run": {"out_dir": str(out_dir)},
        "model": {"task": "im2svg", "name": "tiny", "generation_engine": engine,
                  "from_checkpoint": None, "device": "cpu"},
        "dataset": {"target": "tests.test_torch_validation._MemDataset", "batch_size": 2,
                    "num_samples": n, "params": {"n": n, "im_size": 28}},
        "generation_params": {"max_new_tokens": 8, "temperature": 0.0,
                              "generation_sweep": False},
        "metrics": dict(METRICS),
    }
    for k, v in extra.items():
        cfg[k] = {**cfg.get(k, {}), **v}
    return cfg


@pytest.fixture(scope="module")
def models():
    """A tiny JAX model and the port's on the same weights, fp32, the
    decoder's projections scaled by 10 so that greedy text varies."""
    jm = JModel.from_config(jsv.tiny_config(), jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jm.params)
    for grp in tree["svg_transformer"]["layers"]["attn"], tree["svg_transformer"]["layers"]["mlp"]:
        for p in grp.values():
            p["kernel"] = p["kernel"] * 10.0
    jm.params = jax.tree_util.tree_map(jax.numpy.asarray, tree)
    tm = StarVectorForCausalLM(convert.from_jax_params(tree), tsv.tiny_config(),
                               build_test_tokenizer("v1"), device="cpu",
                               policy=DTypePolicy(torch.float32, torch.float32))
    return jm, tm, tree


# Each package's validator runs in a fresh process of its own: cleaning an
# SVG through cairo names its group after a process-wide surface counter
# (`<g id="surfaceN">`), so both runs must start from the same process state
# for their texts to be comparable.
RUNNER = textwrap.dedent("""
    import json, sys, types
    import numpy as np
    from PIL import Image

    package, weights, config = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
    if package == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        from starvector_tpu.validation.parity_samples import SAMPLES
    else:
        from starvector_tpu_torch.validation.parity_samples import SAMPLES
    {dataset}
    sys.modules["eval_memdataset"] = types.ModuleType("eval_memdataset")
    sys.modules["eval_memdataset"]._MemDataset = _MemDataset
    tree = {{}}
    for key, value in np.load(weights).items():
        node = tree
        *path, leaf = key.split("/")
        for k in path:
            node = node.setdefault(k, {{}})
        node[leaf] = value
    if package == "jax":
        import jax.numpy as jnp
        from starvector_tpu.api import StarVectorForCausalLM
        from starvector_tpu.config import ConfigNode
        from starvector_tpu.models import starvector as sv
        from starvector_tpu.models.tokenizer import build_test_tokenizer
        from starvector_tpu.ops.layers import DTypePolicy
        from starvector_tpu.validation.jax_validator import StarVectorJAXValidator as Validator
        model = StarVectorForCausalLM(jax.tree_util.tree_map(jnp.asarray, tree),
                                      sv.tiny_config(), build_test_tokenizer("v1"),
                                      policy=DTypePolicy(compute_dtype=jnp.float32))
    else:
        import torch
        from starvector_tpu_torch.api import StarVectorForCausalLM
        from starvector_tpu_torch.config import ConfigNode
        from starvector_tpu_torch.models import convert, starvector as sv
        from starvector_tpu_torch.models.tokenizer import build_test_tokenizer
        from starvector_tpu_torch.ops.layers import DTypePolicy
        from starvector_tpu_torch.validation.torch_validator import (
            StarVectorTorchValidator as Validator)
        model = StarVectorForCausalLM(convert.from_jax_params(tree), sv.tiny_config(),
                                      build_test_tokenizer("v1"), device="cpu",
                                      policy=DTypePolicy(torch.float32, torch.float32))
    validator = Validator(ConfigNode(config), model=model)
    validator.validate()
    print(json.dumps({{"out_dir": validator.out_dir,
                      "results": {{sid: {{k: v for k, v in r.items()
                                         if isinstance(v, (str, bool, float, int))}}
                                  for sid, r in validator.results.items()}}}}))
""").format(dataset=textwrap.indent(inspect.getsource(_MemDataset), "    ").strip())


@pytest.fixture(scope="module")
def runs(models, tmp_path_factory):
    """(JAX run, port run), each {"out_dir", "results"}: the two validators
    on the same weights, dataset and config, in two fresh processes at once."""
    tree = models[2]
    out = tmp_path_factory.mktemp("eval")
    flat = {}

    def flatten(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                flatten(v, f"{path}{k}/")
            else:
                flat[path + k] = v

    flatten(tree, "")
    np.savez(out / "weights.npz", **flat)
    procs = []
    for package in ("jax", "torch"):
        cfg = _config(out / package)
        cfg["dataset"]["target"] = "eval_memdataset._MemDataset"
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RUNNER, package, str(out / "weights.npz"), json.dumps(cfg)],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env={**os.environ, "JAX_PLATFORMS": "cpu"}))
    outs = []
    for proc in procs:
        stdout, stderr = proc.communicate(timeout=300)
        assert proc.returncode == 0, stderr[-4000:]
        outs.append(json.loads(stdout.strip().splitlines()[-1]))
    return outs


def test_validator_texts_and_flags_equal_jax(runs):
    ref, ours = (r["results"] for r in runs)
    assert list(ours) == list(ref) == [s[0] for s in SAMPLES[:4]]
    for sid, row in ref.items():
        for key in ("svg", "svg_raw", "post_processed", "no_compile", "gt_svg", "caption"):
            assert ours[sid][key] == row[key], (sid, key)
    raws = [r["svg_raw"] for r in ours.values()]
    assert all(r.startswith("<svg") for r in raws) and len(set(raws)) > 1


def test_validator_files_equal_jax(runs):
    (jdir, tdir) = (r["out_dir"] for r in runs)
    for sid in runs[0]["results"]:
        for suffix in FILES:
            name = suffix[1:] if suffix[0] == "/" else sid + suffix
            a, b = os.path.join(tdir, sid, name), os.path.join(jdir, sid, name)
            if suffix.endswith(".png"):
                np.testing.assert_array_equal(np.asarray(Image.open(a)), np.asarray(Image.open(b)))
            elif suffix.endswith(".json"):
                assert json.load(open(a)) == json.load(open(b))
            else:
                assert open(a).read() == open(b).read()
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))


def test_validator_results_avg_equal_jax(runs):
    ref, ours = (json.load(open(os.path.join(r["out_dir"], "results", "results_avg.json")))
                 for r in runs)
    assert set(ours) == set(ref) == set(METRICS)
    for k, v in ref.items():
        assert ours[k] == pytest.approx(v, abs=1e-6), k


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_validator_all_results_csv_equal_jax(runs):
    """Parsed: the same header, rows and values (floats to 1e-6)."""
    ref, ours = (_rows(os.path.join(r["out_dir"], "results", "all_results.csv")) for r in runs)
    assert ours[0] == ref[0] and len(ours) == len(ref) == 5
    for a, b in zip(ours[1:], ref[1:]):
        assert a[0] == b[0]
        for x, y in zip(a[1:], b[1:]):
            if y in ("True", "False"):
                assert x == y
            else:
                assert float(x) == pytest.approx(float(y), abs=1e-6)


def test_validator_sink_lines_equal_jax(runs):
    ref, ours = ([json.loads(line) for line in open(os.path.join(r["out_dir"], "metrics.jsonl"))]
                 for r in runs)
    assert [sorted(r) for r in ours] == [sorted(r) for r in ref] and len(ours) == 2
    assert ours[0] == pytest.approx(ref[0], abs=1e-6)
    assert ours[1]["table"] == "per_sample_results" and ours[1]["columns"] == ref[1]["columns"]
    for a, b in zip(ours[1]["rows"], ref[1]["rows"]):
        assert a[0] == b[0] and a[1:] == pytest.approx(b[1:], abs=1e-6)


TEXTS = [SAMPLES[0][1], "<svg><path d='M 0 L'/></svg>", "complete garbage",
         '<svg xmlns="http://www.w3.org/2000/svg"><rect width="4" height="4"/>']


def _surface(out: dict) -> dict:
    """The chain's result with cairo's surface counter taken out of the
    cleaned text (`<g id="surfaceN">` counts the surfaces of the process)."""
    return {**out, "svg": re.sub(r'id="surface\d+"', 'id="surface"', out["svg"])}


@pytest.mark.parametrize("text", TEXTS, ids=["valid", "cleanable", "garbage", "unclosed"])
def test_post_process_chain_equals_jax(models, tmp_path, text):
    if text != TEXTS[0] and not rz.rasterizer_available():
        pytest.skip("librsvg/cairo unavailable: cleaning gives the placeholder in both")
    jv = StarVectorJAXValidator(JNode(_config(tmp_path / "j")), model=models[0])
    tv = StarVectorTorchValidator(ConfigNode(_config(tmp_path / "t")), model=models[1])
    ours = tv.post_process_svg(text)
    assert _surface(ours) == _surface(jv.post_process_svg(text))
    if text == TEXTS[0]:
        assert ours == {"svg": text, "svg_raw": text, "post_processed": False,
                        "no_compile": False}
    if text == "complete garbage":
        assert ours["no_compile"] and ours["svg"] == rz.VOID_SVG


def test_engines_and_registry(tmp_path):
    from starvector_tpu.validation.validate import ENGINES as JENGINES

    assert set(vcli.ENGINES) == set(JENGINES)
    assert {k for k, v in vcli.ENGINES.items() if v == "StarVectorTorchValidator"} == {"jax", "hf"}
    assert {k for k, v in vcli.ENGINES.items() if v == "StarVectorServeValidator"} == {
        "vllm", "vllm-api"}
    v = vcli.get_validator(ConfigNode(_config(tmp_path, engine="vllm-api")))
    assert isinstance(v, StarVectorServeValidator)
    assert {"StarVectorTorchValidator", "StarVectorServeValidator"} <= set(validator_registry)
    with pytest.raises(ValueError, match="from_checkpoint required"):
        vcli.get_validator(ConfigNode(_config(tmp_path, engine="hf")))
    with pytest.raises(ValueError, match="not registered"):
        vcli.get_validator(ConfigNode(_config(tmp_path, engine="nope")))


def test_jax_dataset_target_resolves_to_the_port(tmp_path, models):
    """configs/generation/jax/starvector-1b/im2svg.yaml's dataset target,
    starvector_tpu.data.datasets.SVGDataset, is the port's SVGDataset; the
    validator reads it from a local jsonl split."""
    from starvector_tpu_torch.config import get_obj_from_str, load_yaml
    from starvector_tpu_torch.data.datasets import SVGDataset

    target = load_yaml("configs/generation/jax/starvector-1b/im2svg.yaml").get_path(
        "dataset.target")
    assert target == "starvector_tpu.data.datasets.SVGDataset"
    assert get_obj_from_str(target) is SVGDataset
    data = tmp_path / "data"
    data.mkdir()
    with open(data / "test.jsonl", "w") as f:
        for sid, svg in SAMPLES[:3]:
            f.write(json.dumps({"Svg": svg, "Filename": sid + ".svg"}) + "\n")
    cfg = _config(tmp_path / "out", dataset={"target": target, "num_samples": -1, "params": {
        "dataset_name": str(data), "split": "test", "im_size": 28}})
    v = StarVectorTorchValidator(ConfigNode(cfg), model=models[1])
    batches = list(v.get_dataloader())
    assert [b["id"] for b in batches] == [[s[0] + ".svg" for s in SAMPLES[:2]],
                                          [SAMPLES[2][0] + ".svg"]]
    assert batches[0]["image"].shape == (2, 28, 28, 3) and batches[0]["image"].device.type == "cpu"


def test_temperature_sweep_layout_and_grid(tmp_path, models):
    cfg = _config(tmp_path, n=2, generation_params={"temperature": 1.0, "max_new_tokens": 6,
                                                    "generation_sweep": True},
                  generation_sweep={"min_temperature": 0.0, "max_temperature": 1.0,
                                    "num_generations_different_temp": 2},
                  metrics={"SSIM": False, "Masked-L2": False, "CountTokenLength": False})
    v = StarVectorTorchValidator(ConfigNode(cfg), model=models[1])
    avg, per = v.validate()
    assert set(avg) == {"L2", "ratio_post_processed", "ratio_non_compiling"} and len(per) == 2
    for sid in (s[0] for s in SAMPLES[:2]):
        assert list(v.results[sid]) == [0.0, 1.0]
        d = os.path.join(v.out_dir, sid)
        assert sorted(os.listdir(d)) == sorted(
            [sid + s for s in FILES[:5]] + ["metadata.json", f"{sid}_temps.png",
                                            "temp_0", "temp_1"])
        for t in ("temp_0", "temp_1"):
            assert os.listdir(os.path.join(d, t)) == [f"{sid}.png"]
        grid = Image.open(os.path.join(d, f"{sid}_temps.png"))
        assert grid.size == (3 * (512 + 8) + 8, 512 + 28 + 16)  # GT + 2 temperatures


# -- the REST validator ------------------------------------------------------

class _Running:
    def __init__(self, server):
        self.server = server
        self.url = f"http://127.0.0.1:{server.server_address[1]}"
        self.thread = threading.Thread(target=server.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=60)


def test_rest_validator_through_the_port_worker_and_controller(tmp_path, models):
    """Greedy texts through the controller's relay equal offline
    generate_im2svg at B = 1 on the same PIL images."""
    from starvector_tpu_torch.serve.controller import Controller
    from starvector_tpu_torch.serve.controller import build_server as build_controller
    from starvector_tpu_torch.serve.worker import ModelWorker
    from starvector_tpu_torch.serve.worker import build_server as build_worker

    tm = models[1]
    worker = ModelWorker(tm, worker_addr="pending", max_batch=2, max_len=64)
    wsrv, csrv = _Running(build_worker(worker)), _Running(build_controller(Controller()))
    try:
        worker.worker_addr, worker.controller_addr = wsrv.url, csrv.url
        worker.register()
        cfg = _config(tmp_path, engine="vllm", n=3, model={"api_endpoint": csrv.url,
                                                           "name": "starvector"},
                      metrics={"SSIM": False, "Masked-L2": False})
        v = vcli.get_validator(ConfigNode(cfg))
        avg, _ = v.validate()
    finally:
        csrv.close()
        wsrv.close()
        worker.shutdown()
    assert isinstance(v, StarVectorServeValidator) and len(v.results) == 3
    for i, sid in enumerate(v.results):
        pil = _MemDataset(3, 28)[i]["image_pil"]
        ref = tm.generate_im2svg({"image": tm.process_images([pil])}, max_new_tokens=8,
                                 use_nucleus_sampling=False)[0]
        assert v.results[sid]["svg_raw"] == ref
    assert set(avg) >= {"L2", "CountTokenLength", "ratio_non_compiling"}


@pytest.mark.parametrize("failure", ["error_chunk", "http_500"])
def test_rest_validator_raises_on_a_failed_request(tmp_path, failure):
    """A worker that answers an error chunk or HTTP 500: the validator
    raises instead of scoring an empty string."""
    import urllib.error

    from starvector_tpu_torch.serve.httpd import make_server

    def route(handler, body):
        if failure == "http_500":
            handler.send_json({"error": "boom"}, status=500)
            return
        handler.start_stream()
        handler.write_chunk(json.dumps({"text": "<svg", "error_code": 0}).encode() + b"\0")
        handler.write_chunk(json.dumps({"text": "oom", "error_code": 1}).encode() + b"\0")

    srv = _Running(make_server("127.0.0.1", 0, {"/worker_generate_stream": route}))
    try:
        v = StarVectorServeValidator(ConfigNode(_config(tmp_path, engine="vllm", n=1, model={
            "api_endpoint": srv.url})))
        with pytest.raises(urllib.error.HTTPError if failure == "http_500" else RuntimeError,
                           match="500" if failure == "http_500" else "worker stream error 1"):
            v.validate()
    finally:
        srv.close()
    assert not v.results


# -- the sink, the CSV, the plots ----------------------------------------------

def test_metrics_sink_lines_equal_jax(tmp_path):
    from starvector_tpu.utils.logging import MetricsSink as JSink
    from starvector_tpu_torch.utils.logging import MetricsSink

    for sink in (MetricsSink(str(tmp_path / "t"), echo=False, run_name="r"),
                 JSink(str(tmp_path / "j"), echo=False, run_name="r")):
        sink.log({"loss": np.float32(1.5), "n": 3}, step=7)
        sink.log({"step": 2, "x": torch.tensor(0.25)}, step=9)
        sink.log_table("per_sample_results", ["sample_id", "L2"], [["a", np.float64(0.5)],
                                                                   ["b", None]])
        sink.log_image_pairs("comparisons", [("a/gt.png", "a/gen.png")], ["a"])
        sink.finish()
    assert open(tmp_path / "t" / "metrics.jsonl").read() == \
        open(tmp_path / "j" / "metrics.jsonl").read()


def test_results_csv_as_pandas_writes_it(tmp_path):
    """The JAX validator's pandas writer, where every sample has the first
    metric (as the ratio metrics give every validator sample); a sample
    without values keeps its row, which pandas drops."""
    pd = pytest.importorskip("pandas")
    results = {"s0": {"L2": 0.125, "SSIM": 0.9, "ratio_post_processed": True},
               "s1": {"L2": 2.5, "ratio_post_processed": False, "CountTokenLength": -3.0},
               "s2": {"L2": 0.3333333333333333, "SSIM": 1e-05}}
    write_results_csv(str(tmp_path / "ours.csv"), results)
    pd.DataFrame.from_dict(results, orient="index").to_csv(tmp_path / "pandas.csv")
    assert (tmp_path / "ours.csv").read_text() == (tmp_path / "pandas.csv").read_text()
    write_results_csv(str(tmp_path / "empty_row.csv"), {"s0": {}, "s1": {"L2": 1.0}})
    assert _rows(tmp_path / "empty_row.csv") == [["", "L2"], ["s0", ""], ["s1", "1.0"]]


def test_plots():
    from starvector_tpu_torch.utils import plots

    gen = Image.new("RGB", (20, 16), (255, 0, 0))
    gt = Image.new("RGB", (10, 8), (255, 255, 255))
    panel = plots.plot_images_side_by_side(gen, gt)
    assert panel.size == (3 * 20 + 4 * 8, 16 + 2 * 8)
    diff = np.asarray(panel)[8:24, 8 + 2 * 28: 8 + 2 * 28 + 20]
    assert (diff == [0, 255, 255]).all()  # |red - white|
    assert plots.plot_images_side_by_side_with_metrics(gen, gt, 0.5, True).size == (92, 56)


# -- the rasterizer without librsvg/cairo ----------------------------------------

def test_fallbacks_without_the_library_start_no_worker(monkeypatch):
    """Without the library, clean_svg, rasterize_svg and
    process_and_rasterize_svg return what they returned through a failing
    worker before ('<svg></svg>', a white image; the placeholder and a
    white image), and no process starts."""
    import multiprocessing

    def no_library():
        raise RuntimeError("librsvg/cairo not available on this system")

    def no_process(*a, **k):
        raise AssertionError("a worker process was started")

    monkeypatch.setattr(rz, "_available", None)
    monkeypatch.setattr(rz, "_load_lib", no_library)
    monkeypatch.setattr(rz.mp, "get_context", no_process)
    monkeypatch.setattr(multiprocessing.Process, "start", no_process)
    assert not rz.rasterizer_available()
    for svg in (SAMPLES[0][1], "complete garbage"):
        assert rz.clean_svg(svg) == rz.VOID_SVG
        for timeout in (None, 5.0):
            img = rz.rasterize_svg(svg, 40, timeout=timeout)
            assert img.mode == "RGB" and img.size == (40, 40)
            assert (np.asarray(img) == 255).all()
        out, img = rz.process_and_rasterize_svg(svg, 24)
        assert out == (svg if svg == SAMPLES[0][1] else rz.VOID_SVG)
        assert (np.asarray(img) == 255).all() and img.size == (24, 24)
