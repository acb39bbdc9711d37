"""Experiment logger with the reference's directory contract (the JAX
package's io/logger.py; reference multi_stylegan/misc.py:13-180).

Creates ``experiments/<dd_mm_YYYY__HH_MM_SS>/{metrics,hyperparameters,
plots,models}``, appends scalars to in-memory streams flushed as one
``<metric>.npy`` per stream by :meth:`Logger.save`, dumps the
hyperparameters as JSON into ``hyperparameters/hyperparameter.txt``, and
saves sample grids as PNG strips (BF grey, GFP green, RFP red) through the
port's own PNG writer (io/images.py).  With ``tensorboard=True`` every
``log_metric`` scalar also goes to ``<experiment>/tensorboard`` through
``torch.utils.tensorboard``, its step the count of values logged under that
name; where the writer cannot be made (no ``tensorboard`` package) it is
None and nothing is said, as in the JAX logger.  No CLI turns it on.
"""

from __future__ import annotations

import json
import os
from datetime import datetime
from typing import Any, Dict, Iterable, Optional, Union

import numpy as np

from multi_stylegan_torch.io.images import save_prediction


class Logger:
    def __init__(
        self,
        experiment_path: Optional[str] = None,
        experiment_path_extension: str = "",
        path_metrics: str = "metrics",
        path_hyperparameters: str = "hyperparameters",
        path_plots: str = "plots",
        path_models: str = "models",
        tensorboard: bool = False,
    ) -> None:
        if experiment_path is None:
            experiment_path = os.path.join(
                os.getcwd(), "experiments", datetime.now().strftime("%d_%m_%Y__%H_%M_%S"))
        experiment_path = experiment_path + experiment_path_extension
        self.experiment_path = experiment_path
        self.path_metrics = os.path.join(experiment_path, path_metrics)
        self.path_hyperparameters = os.path.join(experiment_path, path_hyperparameters)
        self.path_plots = os.path.join(experiment_path, path_plots)
        self.path_models = os.path.join(experiment_path, path_models)
        for p in (self.path_metrics, self.path_hyperparameters, self.path_plots,
                  self.path_models):
            os.makedirs(p, exist_ok=True)
        self.metrics: Dict[str, list] = {}
        self.temp_metrics: Dict[str, list] = {}
        self.hyperparameters: Dict[str, list] = {}
        self._tb_writer = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb_writer = SummaryWriter(os.path.join(experiment_path, "tensorboard"))
            except Exception:  # noqa: BLE001 - an optional writer, silent as in JAX
                self._tb_writer = None

    def log_metric(self, metric_name: str, value: Any) -> None:
        self.metrics.setdefault(metric_name, []).append(float(value))
        if self._tb_writer is not None:
            self._tb_writer.add_scalar(metric_name, float(value),
                                       global_step=len(self.metrics[metric_name]))

    def log_temp_metric(self, metric_name: str, value: Any) -> None:
        self.temp_metrics.setdefault(metric_name, []).append(float(value))

    def save_temp_metric(self, metric_name: Union[Iterable[str], str]) -> Dict[str, float]:
        """Average the accumulated temp metrics into the main streams
        (misc.py:72-99); clears the temp streams and saves."""
        names = [metric_name] if isinstance(metric_name, str) else list(metric_name)
        averaged = {}
        for name in names:
            value = float(np.mean(self.temp_metrics[name]))
            self.log_metric(name, value)
            averaged[name] = value
        self.temp_metrics = {}
        self.save()
        return averaged

    def log_hyperparameter(self, hyperparameter_name: Optional[str] = None, value: Any = None,
                           hyperparameter_dict: Optional[Dict[str, Any]] = None) -> None:
        if hyperparameter_name is not None and value is not None:
            self.hyperparameters.setdefault(hyperparameter_name, []).append(str(value))
        if hyperparameter_dict is not None:
            for key, v in hyperparameter_dict.items():
                self.hyperparameters.setdefault(key, []).append(str(v))

    def save_prediction(self, prediction, name: str) -> list:
        """[B, domains, T, H, W] predictions as per-sample frame strips in
        ``plots/``, ``{name}_{bf|gfp|rfp}_{index}.png``; returns the paths."""
        return save_prediction(np.asarray(prediction), self.path_plots, name)

    def save(self) -> None:
        if self._tb_writer is not None:
            self._tb_writer.flush()
        with open(os.path.join(self.path_hyperparameters, "hyperparameter.txt"), "w") as f:
            json.dump(self.hyperparameters, f)
        for metric_name, values in self.metrics.items():
            np.save(os.path.join(self.path_metrics, f"{metric_name}.npy"), np.asarray(values))
