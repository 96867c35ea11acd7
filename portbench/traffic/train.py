"""Traffic kind ``train``: one trainer's closed loop of optimizer steps.

Set-up builds one object, the program's train step
(``make_train_step`` over the cell's optimizer) with its model, loads the
benchmark's weights of the seed, and drives it through the first
``checked_steps`` steps by the same call and feed as the window, each on
rows of its own. From them it keeps what the output check compares: each
step's loss, each leaf's first gradient as the optimizer got it (AdamW's
first moment after one step over 1 - beta1) and each leaf's change over
those steps. The window then continues the same object from the next step.

The check runs the configuration's plain reference over the same weights
and batches and compares the relative gap of each step's loss (of the
steps ``loss_steps`` lists, all by default) and, by the worst leaf, the
gap between the program's norm and the reference's, against the
reference's norm of that leaf or of the median leaf, whichever is larger.
"""

from __future__ import annotations

import inspect
import math

import torch

from portbench import data, judge, program


class Job:
    kind = "train"

    def __init__(self, cfg: dict, cell: dict, seed: int, device: torch.device, ref):
        self.cfg, self.cell, self.seed, self.device, self.ref = cfg, cell, seed, device, ref
        t = cell["params"]
        self.batch, self.length = t["batch"], t["seq_len"]
        self.tokens_per_unit = self.batch * self.length
        self.work = ref.work(cfg, self.batch, self.length, train=True)
        self.recipe = t["recipe"]
        if device.type == "cuda":
            program.build_kernels(cfg.get("kernels", ()))
        self.model = program.build_model(cfg, device, t.get("levers"))
        weights = ref.init_params(cfg, seed, device)
        program.load_weights(self.model, weights)
        self.model.train()
        opt_entry = program.resolve(self.recipe["optimizer"])
        accepted = inspect.signature(opt_entry).parameters
        made = opt_entry(self.model, **{k: v for k, v in self.recipe.items()
                                        if k in accepted and k != "model"})
        self.opt, sched = made if isinstance(made, tuple) else (made, None)
        self.step = program.resolve(t["train_step"])(self.model, self.opt, sched,
                                                     clip=self.recipe["clip"])
        self.feed = data.WindowFeed(data.flat_tokens(t["tokens"], seed, device), self.batch,
                                    self.length, seed)
        self.first_window_unit = n = t["checked_steps"]
        names = {id(p): name for name, p in self.model.named_parameters()}
        self.losses = []
        for i in range(n):
            self.losses.append(self.unit(i)["loss"])
            if i == 0:
                b1 = self.opt.param_groups[0]["betas"][0]
                self.grad_norms = {names[id(p)]: torch.linalg.vector_norm(s["exp_avg"]) / (1 - b1)
                                   for p, s in self.opt.state.items()}
        with torch.no_grad():
            self.change_norms = {name: torch.linalg.vector_norm(p.detach() - weights[name])
                                 for name, p in self.model.named_parameters()}
        del weights

    def unit(self, i: int) -> dict:
        x, y = self.feed(i)
        return self.step(x, y)

    def failed(self, outputs: list) -> int:
        if not outputs:
            return 0
        return int((~torch.isfinite(torch.stack([o["loss"] for o in outputs]))).sum())

    def release(self) -> None:
        """Keep the program's readings as numbers and drop its model,
        optimizer and step before the check."""
        self.readings = {"losses": [float(v) for v in self.losses],
                         "grad_norms": {n: float(v) for n, v in self.grad_norms.items()},
                         "change_norms": {n: float(v) for n, v in self.change_norms.items()}}
        del self.step, self.opt, self.model, self.losses, self.grad_norms, self.change_norms

    def reference_run(self, rounding=None) -> dict:
        """The reference's readings over the same weights and batches, in
        float32 or under ``rounding`` (the control)."""
        ref, t = self.ref, self.cell["params"]
        ref.exact_math()
        weights = ref.init_params(self.cfg, self.seed, self.device)
        batches = [self.feed(i) for i in range(self.first_window_unit)]
        out = ref.train_steps(weights, self.cfg, self.recipe, batches,
                              rounding or ref.Rounding(), remat=t["ref_remat"])
        return judge.as_numbers(out)

    def check(self) -> list[dict]:
        return self.compare(self.readings, self.reference_run())

    def compare(self, prog: dict, ref: dict) -> list[dict]:
        """The numbers compared, each with its limit: readings ``prog``
        against the reference's ``ref``."""
        limits = self.cell["limits"]
        gaps = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
        steps = self.cell["params"].get("loss_steps") or range(1, len(gaps) + 1)
        loss_gap = max(gaps[s - 1] for s in steps) if len(gaps) == len(ref["losses"]) else math.inf
        grad_gap, grad_leaf = judge.norm_gap(prog["grad_norms"], ref["grad_norms"])
        moved = judge.moved_leaves(ref["grad_norms"])
        change_gap, change_leaf = judge.norm_gap(prog["change_norms"], ref["change_norms"],
                                                 keep=moved)
        return [
            {"name": "loss_gap", "value": loss_gap, "limit": limits["loss_gap"], "steps": gaps},
            {"name": "grad_gap", "value": grad_gap, "limit": limits["grad_gap"],
             "leaf": grad_leaf},
            {"name": "change_gap", "value": change_gap, "limit": limits["change_gap"],
             "leaf": change_leaf},
        ]
