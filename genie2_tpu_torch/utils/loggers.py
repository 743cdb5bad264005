"""Metric logging adapters (a copy of genie2_tpu/utils/loggers.py; numpy
only).

`LoggerSet` always writes JSONL (machine-readable, no dependencies) and
attaches wandb / TensorBoard sinks only when the libraries are importable
and enabled.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np


class JsonlLogger:
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path

    def log(self, step: int, metrics: Dict, prefix: str = ""):
        record = {"step": step}
        if prefix:
            record["prefix"] = prefix
        record.update({k: float(np.asarray(v)) for k, v in metrics.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def finish(self):
        pass


class WandbLogger:
    def __init__(self, project: str, name: Optional[str] = None, config=None):
        import wandb  # noqa: F401 — optional dependency

        self._run = wandb.init(project=project, name=name, config=config)

    def log(self, step: int, metrics: Dict, prefix: str = ""):
        payload = {
            (f"{prefix}/{k}" if prefix else k): float(np.asarray(v))
            for k, v in metrics.items()
        }
        self._run.log(payload, step=step)

    def finish(self):
        self._run.finish()


class TensorBoardLogger:
    def __init__(self, logdir: str):
        from torch.utils.tensorboard import SummaryWriter  # optional

        self._writer = SummaryWriter(logdir)

    def log(self, step: int, metrics: Dict, prefix: str = ""):
        for k, v in metrics.items():
            tag = f"{prefix}/{k}" if prefix else k
            self._writer.add_scalar(tag, float(np.asarray(v)), step)

    def finish(self):
        self._writer.close()


class LoggerSet:
    """JSONL always; wandb / TensorBoard attached opportunistically."""

    def __init__(
        self,
        logdir: str,
        wandb_project: Optional[str] = None,
        run_name: Optional[str] = None,
        tensorboard: bool = False,
        config=None,
    ):
        self.loggers = [JsonlLogger(os.path.join(logdir, "metrics.jsonl"))]
        if wandb_project:
            try:
                self.loggers.append(WandbLogger(wandb_project, run_name, config))
            except Exception:
                pass
        if tensorboard:
            try:
                self.loggers.append(TensorBoardLogger(os.path.join(logdir, "tb")))
            except Exception:
                pass

    def log(self, step: int, metrics: Dict, prefix: str = ""):
        for logger in self.loggers:
            logger.log(step, metrics, prefix)

    def finish(self):
        for logger in self.loggers:
            logger.finish()
