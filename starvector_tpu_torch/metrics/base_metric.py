"""Per-sample metric loop with NaN skipping (reference:
starvector/metrics/base_metric.py:5-50; the port's copy of
starvector_tpu/metrics/base_metric.py, which the port does not import)."""

from __future__ import annotations

import math

from starvector_tpu_torch.metrics.util import AverageMeter


class BaseMetric:
    def __init__(self):
        self.meter = AverageMeter()
        self.class_name = self.__class__.__name__

    def reset(self):
        self.meter.reset()

    def calculate_score(self, batch: dict, update: bool = True):
        """batch: {"gt_im": [PIL], "gen_im": [PIL], "gt_svg": [...], ...}
        Returns (average, per_sample_values). per_sample_values is
        INDEX-ALIGNED with the batch: skipped samples (exception or NaN)
        hold None, so callers can attribute scores to the right sample ids
        (the reference's enumerate-over-survivors misattributes them,
        starvector/metrics/base_metric.py:29-50 + metrics.py:77-84)."""
        values: list = []
        batch_size = len(next(iter(batch.values())))
        for index in range(batch_size):
            kwargs = {}
            for key in ("gt_im", "gen_im", "gt_svg", "gen_svg", "caption"):
                if key in batch:
                    kwargs[key] = batch[key][index]
            try:
                measure = self.metric(**kwargs)
            except Exception as e:  # noqa: BLE001 — reference logs and skips
                print(f"Error calculating metric: {e}")
                values.append(None)
                continue
            if measure is None or math.isnan(measure):
                values.append(None)
                continue
            values.append(measure)

        valid = [v for v in values if v is not None]
        if not valid:
            print("No valid values found for metric calculation.")
            return float("nan"), values

        score = sum(valid) / len(valid)
        if update:
            self.meter.update(score, len(valid))
            return self.meter.avg, values
        return score, values

    def metric(self, **kwargs):
        raise NotImplementedError

    def get_average_score(self):
        return self.meter.avg
