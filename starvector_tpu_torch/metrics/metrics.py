"""Metrics orchestrator (reference: starvector/metrics/metrics.py:13-127;
the port of starvector_tpu/metrics/metrics.py): config-gated metric set,
auto-rasterization of SVG-only batches, per-sample + average dicts, FID
average-only, ratio metrics from post-process flags. The neural metrics run
on `device`: the card unless the caller asks for the CPU."""

from __future__ import annotations

from starvector_tpu_torch.metrics.l2 import L2DistanceCalculator
from starvector_tpu_torch.metrics.model_metrics import (
    CLIPScoreCalculator,
    CountTokenLength,
    DINOScoreCalculator,
    FIDCalculator,
    LPIPSDistanceCalculator,
)
from starvector_tpu_torch.metrics.ssim import SSIMDistanceCalculator
from starvector_tpu_torch.metrics.util import AverageMeter


def _get_sample_id(json_item: dict):
    return json_item.get("outpath_filename") or json_item.get("sample_id")


class SVGMetrics:
    def __init__(self, config: dict | None = None, device="cuda"):
        self.class_name = self.__class__.__name__
        default_config = {
            "L2": True,
            "Masked-L2": False,
            "LPIPS": False,
            "SSIM": False,
            "FID": False,
            "FID_clip": False,
            "CLIPScore": False,
            "CountTokenLength": False,
            "ratio_post_processed": True,
            "ratio_non_compiling": True,
            "DinoScore": False,
        }
        self.config = dict(default_config, **(config or {}))

        factories = {
            "L2": L2DistanceCalculator,
            "Masked-L2": lambda: L2DistanceCalculator(masked_l2=True),
            "LPIPS": lambda: LPIPSDistanceCalculator(device=device),
            "SSIM": SSIMDistanceCalculator,
            "FID": lambda: FIDCalculator(model_name="InceptionV3", device=device),
            "FID_clip": lambda: FIDCalculator(model_name="ViT-B/32", device=device),
            "CLIPScore": lambda: CLIPScoreCalculator(device=device),
            "CountTokenLength": CountTokenLength,
            "ratio_post_processed": AverageMeter,
            "ratio_non_compiling": AverageMeter,
            "DinoScore": lambda: DINOScoreCalculator(device=device),
        }
        self.active_metrics = {
            k: v() for k, v in factories.items() if self.config.get(k)
        }

    def reset(self):
        for m in self.active_metrics.values():
            m.reset()

    def batch_contains_raster(self, batch):
        return "gt_im" in batch and "gen_im" in batch

    def calculate_metrics(self, batch: dict, update: bool = True):
        if not self.batch_contains_raster(batch):
            from starvector_tpu_torch.data.rasterize import rasterize_svg

            batch["gt_im"] = [rasterize_svg(s) for s in batch["gt_svg"]]
            batch["gen_im"] = [rasterize_svg(s) for s in batch["gen_svg"]]

        avg_results: dict = {}
        all_results: dict = {}
        for i, item in enumerate(batch["json"]):
            sid = _get_sample_id(item)
            if sid is None:
                raise ValueError(
                    f"missing outpath_filename/sample_id in batch['json'][{i}]"
                )
            all_results[sid] = {}

        per_sample = {
            "L2", "Masked-L2", "SSIM", "CLIPScore", "LPIPS",
            "CountTokenLength", "DinoScore",
        }
        for name, metric in self.active_metrics.items():
            print(f"Calculating {name}...")
            if name in per_sample:
                avg, values = metric.calculate_score(batch, update=update)
                avg_results[name] = avg
                for i, v in enumerate(values):
                    if v is not None:  # skipped samples stay unattributed
                        all_results[_get_sample_id(batch["json"][i])][name] = v
            elif name in ("FID", "FID_clip"):
                avg_results[name] = metric.calculate_score(batch)
            else:
                self._handle_ratio_metric(name, metric, batch, avg_results, all_results)
            metric.reset()
        print("Average results:\n", avg_results)
        return avg_results, all_results

    def get_average_metrics(self):
        out = {}
        for name, metric in self.active_metrics.items():
            if hasattr(metric, "avg"):
                out[name] = metric.avg
            elif hasattr(metric, "get_average_score"):
                out[name] = metric.get_average_score()
        return out

    def _handle_ratio_metric(self, name, meter, batch, avg_results, all_results):
        key = name.replace("avg_", "").replace("ratio_", "")
        # validator results carry the flag as 'no_compile'
        # (reference svg_validator_base.py:380-406); the reference's own
        # handler looks up 'non_compiling' and would KeyError — repaired in
        # the JAX package and here
        if key == "non_compiling":
            key = "no_compile"
        for item in batch["json"]:
            sid = _get_sample_id(item)
            value = item[key]
            all_results[sid][name] = value
            meter.update(value, 1)
        avg_results[name] = meter.avg
