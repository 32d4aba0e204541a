"""Metrics logging facade: JSONL file + stdout + optional wandb.

Counterpart of `pde_policylearning_tpu/utils/logging.py` (reference: wandb
throughout the entry scripts, run_pde_observers.py:140-164, run_control.py:
91-93, trainer.py:244, control_env.py:379-402).  The compute path needs
no logging package; without wandb the logger writes its JSONL file (the
reference's hardcoded API key is not replicated)."""
from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricsLogger:
    def __init__(self, log_dir: Optional[str] = None,
                 use_wandb: bool = False, project: Optional[str] = None,
                 name: Optional[str] = None, config: Optional[dict] = None,
                 verbose: bool = False):
        self.verbose = verbose
        self._file = None
        self._wandb = None
        self._step = 0
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            path = os.path.join(log_dir, f"metrics_{int(time.time())}.jsonl")
            self._file = open(path, "a")
            self.path = path
        if use_wandb:
            try:
                import wandb
                self._wandb = wandb
                wandb.init(project=project, name=name, config=config or {})
            except Exception as e:
                print(f"wandb unavailable ({e}); falling back to jsonl")

    def log(self, metrics: dict, step: Optional[int] = None):
        step = self._step if step is None else step
        self._step = step + 1
        record = {"step": step, **{k: float(v) if hasattr(v, "__float__")
                                   else v for k, v in metrics.items()}}
        if self._file:
            self._file.write(json.dumps(record) + "\n")
            self._file.flush()
        if self._wandb:
            self._wandb.log(metrics, step=step)
        if self.verbose:
            print(record)

    def log_image(self, name: str, image):
        if self._wandb:
            self._wandb.log({name: self._wandb.Image(image)})

    def define_metric(self, *args, **kwargs):
        """wandb.define_metric passthrough (run_control.py:91-93)."""
        if self._wandb:
            self._wandb.define_metric(*args, **kwargs)

    def finish(self):
        if self._file:
            self._file.close()
            self._file = None
        if self._wandb:
            self._wandb.finish()
