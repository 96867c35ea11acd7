"""Traffic kind ``score``: one client's closed loop of scoring requests.

A request is ``batch`` windows of ``seq_len`` tokens from the seed's token
array, sent when the previous one has been answered (dispatched ahead: the
host does not wait). Two request shapes, named by ``request``:

- ``scorer``: the program's scoring entry ``entry(model, ids)`` (for
  HyenaDNA ``models.dna.score``), whose answer per row is ``answer`` (mean
  bits per base over the next-token predictions of positions 1..L-1);
- ``eval_loss``: the model in ``eval()`` under ``no_grad``, then the
  program's ``loss`` (``utils.metrics.cross_entropy``) over all positions,
  as the LM trainer's evaluation runs it; the answer is that mean loss.

For the output check a forward hook on the model keeps, for the requests
drawn from the seed, what the timed path produced: the logits at
``check_positions`` positions of each row (all of them when it is null)
and every position's negative log-likelihood of its next token. After the
window the plain reference scores the same rows, and the check compares
the widest gap in log-probability and the relative gap of each answer.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench import data, judge, program

LN2 = math.log(2.0)


class Job:
    kind = "score"

    def __init__(self, cfg: dict, cell: dict, seed: int, device: torch.device, ref):
        self.cfg, self.cell, self.seed, self.device, self.ref = cfg, cell, seed, device, ref
        t = self.params = cell["params"]
        self.batch, self.length = t["batch"], t["seq_len"]
        self.tokens_per_unit = self.batch * self.length
        self.work = ref.work(cfg, self.batch, self.length, train=False)
        if device.type == "cuda":
            program.build_kernels(cfg.get("kernels", ()))
        self.model = program.build_model(cfg, device, t.get("levers"))
        program.load_weights(self.model, ref.init_params(cfg, seed, device))
        self.model.eval()
        self.feed = data.WindowFeed(data.flat_tokens(t["tokens"], seed, device), self.batch,
                                    self.length, seed)
        rng = np.random.default_rng(seed)
        self.first_window_unit = warm = t["warmup_requests"]
        self.sampled = sorted(int(i) for i in rng.choice(
            np.arange(warm, warm + t["sample_within"]), t["check_requests"], replace=False))
        n_pos = t.get("check_positions")
        self.positions = None if n_pos is None else torch.from_numpy(
            np.sort(rng.choice(self._targets_len(), n_pos, replace=False))).to(device)
        self.kept: dict[int, dict] = {}
        self._keep = None
        self.hook = self.model.register_forward_hook(self._observe)
        for i in range(warm):
            self.unit(i)

    def _targets_len(self) -> int:
        return self.length - 1 if self.params["request"] == "scorer" else self.length

    def _observe(self, module, inputs, logits):
        """Keep the sampled request's logits and next-token NLL."""
        if self._keep is None:
            return
        with torch.no_grad():
            lg, targets = logits.float(), self._keep["targets"]
            if self.params["request"] == "scorer":
                lg = lg[:, :-1]
            nll = None  # rows missing: the comparison reads it as infinitely far
            if lg.shape[:2] == targets.shape:
                nll = torch.logsumexp(lg, dim=-1) - lg.gather(-1, targets[..., None])[..., 0]
            rows = lg if self.positions is None else lg[:, self.positions]
            self._keep.update({"rows": rows.clone(), "nll": nll})

    def unit(self, i: int):
        x, y = self.feed(i)
        if self.params["request"] == "scorer":
            ids = x
            self._keep = {"targets": ids[:, 1:]} if i in self.sampled else None
            out = program.resolve(self.params["entry"])(self.model, ids)
            answer = out[self.params["answer"]]
        else:
            self._keep = {"targets": y} if i in self.sampled else None
            with torch.no_grad():
                answer = program.resolve(self.params["loss"])(self.model(x), y)
        if self._keep is not None:
            self._keep["answer"] = answer
            self.kept[i] = self._keep
            self._keep = None
        return answer

    def failed(self, outputs: list) -> int:
        return sum(int((~torch.isfinite(o.reshape(-1))).any()) for o in outputs)

    def release(self) -> None:
        """Drop the program's model before the check; keep what was kept."""
        self.hook.remove()
        del self.model

    def reference_answers(self, i: int, rounding=None) -> dict:
        """The reference's rows, next-token NLL and answer for request i."""
        ref = self.ref
        ref.exact_math()
        weights = ref.init_params(self.cfg, self.seed, self.device)
        x, y = self.feed(i)
        rows, nlls = [], []
        with torch.no_grad():
            for b in range(self.batch):
                lg = ref.logits(weights, self.cfg, x[b : b + 1], rounding or ref.Rounding())
                if self.params["request"] == "scorer":
                    lg, tg = lg[:, :-1], x[b : b + 1, 1:]
                else:
                    tg = y[b : b + 1]
                nlls.append(ref.token_nll(lg, tg))
                rows.append(lg if self.positions is None else lg[:, self.positions])
                del lg
        nll = torch.cat(nlls)
        answer = nll.mean(dim=1) / LN2 if self.params["request"] == "scorer" else nll.mean()
        return {"rows": torch.cat(rows), "nll": nll, "answer": answer}

    def check(self) -> list[dict]:
        return self.compare(self.kept, {i: self.reference_answers(i) for i in self.sampled})

    def compare(self, prog: dict, ref: dict) -> list[dict]:
        """The widest log-probability gap and the largest relative answer
        gap over the sampled requests; a request that never came reads as
        infinitely far."""
        limits = self.cell["limits"]
        logp, answer = 0.0, 0.0
        for i, r in ref.items():
            p = prog.get(i)
            if p is None or "rows" not in p or p["rows"].shape != r["rows"].shape:
                logp = answer = float("inf")
                continue
            a, b = p["answer"].float().reshape(-1), r["answer"].float().reshape(-1)
            if a.shape != b.shape or p["nll"] is None or p["nll"].shape != r["nll"].shape:
                logp = answer = float("inf")
                continue
            logp = max(logp, judge.logp_gap(p["rows"], r["rows"]),
                       float((p["nll"] - r["nll"]).abs().max()))
            answer = max(answer, float(((a - b).abs() / b.abs()).max()))
        return [{"name": "logp_gap", "value": logp, "limit": limits["logp_gap"]},
                {"name": "answer_gap", "value": answer, "limit": limits["answer_gap"]}]
