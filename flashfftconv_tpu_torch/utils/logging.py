"""Experiment logging: JSONL metric records, mirrored to wandb when asked.

Port of the JAX package's ``utils/logging.py``: the same records in the
same file. ``use_wandb`` degrades to JSONL alone when wandb is absent or
cannot start (an offline machine).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any


class MetricLogger:
    def __init__(self, logdir: str = "./logs", run_name: str | None = None,
                 use_wandb: bool = False, config: dict | None = None):
        # ``logdir`` may also be an exact .jsonl file path (the examples pass
        # --log-file straight through).
        if logdir.endswith(".jsonl"):
            parent = os.path.dirname(logdir)
            if parent:
                os.makedirs(parent, exist_ok=True)
            self.path = logdir
            run_name = run_name or os.path.splitext(os.path.basename(logdir))[0]
        else:
            os.makedirs(logdir, exist_ok=True)
            run_name = run_name or time.strftime("run-%Y%m%d-%H%M%S")
            self.path = os.path.join(logdir, f"{run_name}.jsonl")
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb.init(project="flashfftconv-tpu", name=run_name,
                                         config=config or {})
            except Exception as e:  # offline or absent: JSONL alone
                print(f"wandb unavailable ({e}); logging to {self.path} only")
        if config:
            self.log({"_config": config, "step": -1})

    def log(self, metrics: dict[str, Any], step: int | None = None) -> None:
        """Append one record: every value that has ``.item`` (a tensor or a
        numpy scalar) as a float, ``step`` and the wall-clock ``time``."""
        rec = {k: (float(v) if hasattr(v, "item") else v) for k, v in metrics.items()}
        if step is not None:
            rec["step"] = step
        rec.setdefault("time", time.time())
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._wandb is not None:
            self._wandb.log({k: v for k, v in rec.items() if not k.startswith("_")})

    def finish(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()
