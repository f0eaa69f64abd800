"""Validation harness: registry + base class + output layout (the port of
starvector_tpu/validation/svg_validator_base.py).

Rebuilds the reference harness (reference: starvector/validation/
svg_validator_base.py): per-sample output dirs with {id}.svg / _raw.svg /
_gt.svg + 512px PNGs + metadata.json, the parse→clean→placeholder
post-process chain recording post_processed/no_compile flags (:380-406),
temperature sweep (:276-296), and results_avg.json + all_results.csv
(:321-345, written with the csv module). wandb is optional; metrics always
also land in jsonl. The neural metrics run on the validator's device.
"""

from __future__ import annotations

import csv
import json
import os
from abc import ABC, abstractmethod
from copy import deepcopy
from datetime import datetime
from typing import Type

import numpy as np

from starvector_tpu_torch.config import ConfigNode
from starvector_tpu_torch.data.rasterize import clean_svg, rasterize_svg, use_placeholder
from starvector_tpu_torch.data.svg_util import is_valid_svg_strict
from starvector_tpu_torch.metrics import SVGMetrics

validator_registry: dict[str, Type["SVGValidator"]] = {}


def register_validator(cls):
    validator_registry[cls.__name__] = cls
    return cls


def write_results_csv(path: str, all_results: dict) -> None:
    """{sample id: {metric: value}} as pandas' DataFrame.from_dict(...,
    orient="index").to_csv writes it (the JAX package's writer): an unnamed
    index column, the metrics in order of first appearance, an empty cell
    where a sample lacks one. Unlike pandas, every sample keeps its row, in
    the samples' order: pandas drops a sample without values and orders
    the rows by their first appearance column by column."""
    cols: list = []
    for row in all_results.values():
        cols += [k for k in row if k not in cols]
    with open(path, "w", newline="") as f:
        out = csv.writer(f, lineterminator="\n")
        out.writerow([""] + cols)
        for sid, row in all_results.items():
            out.writerow([sid] + [row.get(c, "") for c in cols])


class SVGValidator(ABC):
    def __init__(self, config: ConfigNode, device=None):
        """`device`: where the neural metrics run (the model's, for the
        in-process validator); by default `model.device`, the card unless
        the config says `model.device: cpu`."""
        self.config = config
        self.task = config.get_path("model.task", "im2svg")
        date_time = datetime.now().strftime("%Y%m%d_%H%M%S")
        engine = config.get_path("model.generation_engine", "jax")
        model_name = config.get_path("model.name", "starvector")
        ds_name = str(config.get_path("dataset.dataset_name", "dataset")).replace("/", "_")
        base = config.get_path("run.out_dir", "eval")
        self.out_dir = os.path.join(base, f"{engine}_{model_name}_{ds_name}_{date_time}")
        os.makedirs(self.out_dir, exist_ok=True)
        with open(os.path.join(self.out_dir, "config.yaml"), "w") as f:
            f.write(config.to_yaml() if hasattr(config, "to_yaml") else str(config))
        print(f"Out dir: {self.out_dir}")

        metrics_cfg = config.get_path("metrics")
        if metrics_cfg is None:
            path = f"configs/metrics/{self.task}.yaml"
            if os.path.exists(path):
                from starvector_tpu_torch.config import load_yaml

                metrics_cfg = load_yaml(path).get("metrics", {})
            else:
                metrics_cfg = {}
        if device is None:
            device = config.get_path("model.device", "cuda")
        self.metrics = SVGMetrics(dict(metrics_cfg), device=device)
        self.results: dict[str, dict] = {}

        from starvector_tpu_torch.utils.logging import MetricsSink

        self.sink = MetricsSink(
            self.out_dir,
            report_to=config.get_path("run.report_to"),
            project=config.get_path("run.project_name", "starvector-eval"),
            run_name=config.get_path("run.run_id"),
            config=config.to_dict() if hasattr(config, "to_dict") else None,
            echo=False,
        )
        self.log_images = bool(config.get_path("run.log_images", False))

    # -- to implement ---------------------------------------------------------
    @abstractmethod
    def generate_svg(self, batch: dict, generate_config: dict) -> list[str]:
        ...

    @abstractmethod
    def get_dataloader(self):
        ...

    def iter_dataset_batches(self, *, default_batch_size: int = 2):
        """Shared dataset slicing for validators: instantiate the config's
        dataset (a `starvector_tpu.data.X` target is the port's
        `starvector_tpu_torch.data.X`: config.port_target), honor
        dataset.num_samples, yield raw item lists of batch_size (backends
        shape them into their own batch dicts)."""
        from starvector_tpu_torch.config import instantiate_from_config

        ds = instantiate_from_config(self.config.get_path("dataset"))
        bs = int(self.config.get_path("dataset.batch_size", default_batch_size))
        n = len(ds)
        limit = self.config.get_path("dataset.num_samples", -1)
        if limit and limit != -1:
            n = min(n, int(limit))
        for start in range(0, n, bs):
            yield [ds[i] for i in range(start, min(start + bs, n))]

    def release_memory(self):
        pass

    # -- main loop ------------------------------------------------------------
    def validate(self):
        sweep = bool(self.config.get_path("generation_params.generation_sweep", False))
        for batch in self.get_dataloader():
            if sweep:
                results = self.run_temperature_sweep(batch)
            else:
                gen_cfg = dict(self.config.get_path("generation_params", {}) or {})
                results = self.generate_and_process_batch(batch, gen_cfg)
            self.save_results(results, batch)
        self.release_memory()
        return self.calculate_and_save_metrics()

    def generate_and_process_batch(self, batch, generate_config):
        outputs = self.generate_svg(batch, generate_config)
        return [self.post_process_svg(o) for o in outputs]

    def run_temperature_sweep(self, batch):
        """reference :276-296"""
        out: dict = {}
        temps = np.linspace(
            float(self.config.get_path("generation_sweep.min_temperature", 0.0)),
            float(self.config.get_path("generation_sweep.max_temperature", 1.0)),
            int(self.config.get_path("generation_sweep.num_generations_different_temp", 3)),
        ).tolist()
        for temp in temps:
            gen_cfg = deepcopy(dict(self.config.get_path("generation_params", {}) or {}))
            gen_cfg["temperature"] = temp
            results = self.generate_and_process_batch(batch, gen_cfg)
            for i, sid in enumerate(batch["id"]):
                sid = str(sid).split(".")[0]
                out.setdefault(sid, {})[temp] = results[i]
        return out

    # -- post-processing (reference :380-406) --------------------------------
    def post_process_svg(self, text: str) -> dict:
        if is_valid_svg_strict(text):
            return {"svg": text, "svg_raw": text,
                    "post_processed": False, "no_compile": False}
        cleaned = clean_svg(text)
        if is_valid_svg_strict(cleaned) and cleaned.strip() != use_placeholder():
            return {"svg": cleaned, "svg_raw": text,
                    "post_processed": True, "no_compile": False}
        return {"svg": use_placeholder(), "svg_raw": text,
                "post_processed": True, "no_compile": True}

    # -- persistence (reference :217-274) -------------------------------------
    def save_results(self, results, batch):
        sweep = isinstance(results, dict)
        for i, gt_svg in enumerate(batch["svg"]):
            sample_id = str(batch["id"][i]).split(".")[0]
            if sweep:
                res_all = results[sample_id]
                res = res_all[list(res_all.keys())[0]]
                self.results[sample_id] = res_all
            else:
                res = results[i]
                self.results[sample_id] = res
            res["sample_id"] = sample_id
            res["outpath_filename"] = sample_id
            res["gt_svg"] = gt_svg
            if "caption" in batch:      # CLIPScore needs it (text2svg runs)
                res["caption"] = batch["caption"][i]

            sample_dir = os.path.join(self.out_dir, sample_id)
            os.makedirs(sample_dir, exist_ok=True)
            gen_raster, gt_raster = self._save_svg_files(sample_dir, sample_id, res)
            meta = {k: v for k, v in res.items() if isinstance(
                v, (str, int, float, bool, type(None)))}
            with open(os.path.join(sample_dir, "metadata.json"), "w") as f:
                json.dump(meta, f, indent=4, sort_keys=True)
            res["gen_im"] = gen_raster
            res["gt_im"] = gt_raster
            if sweep:
                self._save_sweep_grid(sample_dir, sample_id, res_all, gt_raster)

    def _save_sweep_grid(self, sample_dir, sample_id, res_all, gt_raster):
        """Per-temperature rasters + the comparison grid (reference
        temperature-sweep plots, svg_validator_base.py:276-296, 436-451)."""
        from starvector_tpu_torch.metrics.l2 import L2DistanceCalculator
        from starvector_tpu_torch.utils import plots

        l2 = L2DistanceCalculator()
        samples, metrics = {}, {}
        for temp, r in res_all.items():
            tdir = os.path.join(sample_dir, f"temp_{temp:g}")
            os.makedirs(tdir, exist_ok=True)
            raster = rasterize_svg(r["svg"], resolution=512, dpi=100, scale=1)
            raster.save(os.path.join(tdir, f"{sample_id}.png"))
            samples[temp] = {"gen_im": raster, "gt_im": gt_raster}
            try:
                metrics[temp] = {
                    "mse": l2.l2_distance(gt_im=gt_raster, gen_im=raster)
                }
            except Exception:  # noqa: BLE001 — plot survives metric failure
                metrics[temp] = {}
        plots.plot_images_side_by_side_temperatures(samples, metrics, sample_dir, sample_id)

    def _save_svg_files(self, sample_dir, name, res):
        with open(os.path.join(sample_dir, f"{name}.svg"), "w", encoding="utf-8") as f:
            f.write(res["svg"])
        with open(os.path.join(sample_dir, f"{name}_raw.svg"), "w", encoding="utf-8") as f:
            f.write(res["svg_raw"])
        with open(os.path.join(sample_dir, f"{name}_gt.svg"), "w", encoding="utf-8") as f:
            f.write(res["gt_svg"])
        gen_raster = rasterize_svg(res["svg"], resolution=512, dpi=100, scale=1)
        gt_raster = rasterize_svg(res["gt_svg"], resolution=512, dpi=100, scale=1)
        gen_raster.save(os.path.join(sample_dir, f"{name}_generated.png"))
        gt_raster.save(os.path.join(sample_dir, f"{name}_original.png"))
        return gen_raster, gt_raster

    # -- metrics (reference :321-345) -----------------------------------------
    def preprocess_results(self) -> dict:
        batch = {"gen_svg": [], "gt_svg": [], "gen_im": [], "gt_im": [],
                 "json": []}
        sweep = bool(self.config.get_path("generation_params.generation_sweep", False))
        results = list(self.results.items())
        has_captions = all(
            "caption" in (rd[list(rd.keys())[0]] if sweep else rd)
            for _, rd in results
        ) and bool(results)
        if has_captions:
            batch["caption"] = []
        for sample_id, rd in results:
            res = rd[list(rd.keys())[0]] if sweep else rd
            batch["gen_svg"].append(res["svg"])
            batch["gt_svg"].append(res["gt_svg"])
            batch["gen_im"].append(res["gen_im"])
            batch["gt_im"].append(res["gt_im"])
            if has_captions:
                batch["caption"].append(res["caption"])
            batch["json"].append(res)
        return batch

    def calculate_and_save_metrics(self):
        batch = self.preprocess_results()
        avg_results, all_results = self.metrics.calculate_metrics(batch)
        out = os.path.join(self.out_dir, "results")
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "results_avg.json"), "w") as f:
            json.dump(avg_results, f, indent=4, sort_keys=True)
        write_results_csv(os.path.join(out, "all_results.csv"), all_results)
        self._log_comparison(avg_results, all_results)
        return avg_results, all_results

    def _log_comparison(self, avg_results: dict, all_results: dict):
        """Scalars + per-sample comparison table (+ optional image pairs) to
        the sink (reference's wandb tables/plots, svg_validator_base.py:436-451)."""
        self.sink.log({k: v for k, v in avg_results.items()
                       if isinstance(v, (int, float))})
        if all_results:
            cols = sorted({
                k for row in all_results.values()
                for k, v in row.items() if isinstance(v, (int, float, bool))
            })
            rows = [
                [sid] + [row.get(c) for c in cols]
                for sid, row in all_results.items()
            ]
            self.sink.log_table("per_sample_results", ["sample_id"] + cols, rows)
        if self.log_images:
            pairs, caps = [], []
            for sid in list(self.results)[:32]:
                d = os.path.join(self.out_dir, sid)
                pairs.append((
                    os.path.join(d, f"{sid}_original.png"),
                    os.path.join(d, f"{sid}_generated.png"),
                ))
                caps.append(sid)
            self.sink.log_image_pairs("comparisons", pairs, caps)
