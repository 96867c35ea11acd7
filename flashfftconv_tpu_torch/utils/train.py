"""Training steps for the port's models (PyTorch).

Port of the train and eval steps of the JAX package's ``utils/train.py``
and of the ``examples/lm/train.py`` recipe: clip the gradients' global norm,
then AdamW on every parameter under a linear-warmup cosine schedule that
starts at 0. On the card every long and short conv's gradient comes from
the backward kernels (``FftConvFunction``, ``DepthwiseFunction``).

    model = ConvLMHeadModel(...)                      # on "cuda" by default
    opt, sched = lm_optimizer(model, lr=3e-4, weight_decay=0.1, warmup=20, steps=200)
    step = make_train_step(model, opt, sched, clip=1.0)
    metrics = step(x, y)                              # x, y (B, L) token ids

``dna_optimizer`` is the ``examples/hyena_dna`` recipe: the same clip, then
AdamW at a constant lr 6e-4 with weight decay 0.1, no schedule
(``make_train_step(model, dna_optimizer(model))``). ``bert_optimizer`` is
the ``examples/bert`` recipe: clip 1.0, AdamW at lr 8e-4 with weight decay
1e-5 on every parameter, with ``mlm_loss``, the masked-LM loss and
accuracy over the masked positions only (``make_train_step(model,
bert_optimizer(model), loss_fn=mlm_loss)``).

A model whose Hyena mixers run on a sequence mesh (``seq_mesh`` in
``mixer_kwargs``) takes the same step on every rank of the mesh, each on its
chunk of the sequence: ``parallel.seq_conv.seq_backward`` runs the backward
of the global mean loss and sums the replicated parameters' grads over the
mesh before the clip, so every rank takes the same optimizer step.

``TrainState`` holds what a run resumes from (the step, the module, the
optimizer and its scheduler). ``save_checkpoint`` writes their state dicts
with ``torch.save`` into a directory (the JAX package's orbax checkpoints
are directories too, which ``latest_checkpoint`` compares by mtime), and
``restore_checkpoint`` loads them back in place, bit for bit.
``auto_save_on_exception`` writes an emergency checkpoint when a training
loop dies; ``evaluate`` counts a classifier's correct rows over a split in
padded batches; ``ProgressiveResizing`` is the sequence-length curriculum.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from flashfftconv_tpu_torch.parallel.seq_conv import seq_backward, seq_group
from flashfftconv_tpu_torch.utils.metrics import accuracy, cross_entropy
from flashfftconv_tpu_torch.utils.optim import lr_lambda, warmup_cosine_decay_schedule


def lm_optimizer(model: nn.Module, lr: float = 3e-4, weight_decay: float = 0.1,
                 warmup: int = 20, steps: int = 200):
    """The ``examples/lm`` optimizer: AdamW (betas 0.9/0.999, eps 1e-8,
    decoupled decay scaled by lr) on every parameter, with lr following
    ``warmup_cosine_decay_schedule(0, lr, warmup', max(steps, warmup' + 1))``
    where warmup' = min(warmup, max(steps // 2, 1)), as the script clamps it.
    Returns (optimizer, scheduler); the first update runs at lr = 0."""
    warmup = min(warmup, max(steps // 2, 1))
    schedule = warmup_cosine_decay_schedule(0.0, lr, warmup, max(steps, warmup + 1))
    opt = torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, lr_lambda(schedule, lr))


def dna_optimizer(model: nn.Module, lr: float = 6e-4, weight_decay: float = 0.1):
    """The ``examples/hyena_dna`` optimizer: AdamW (betas 0.9/0.999, eps 1e-8,
    decoupled decay scaled by lr) on every parameter at a constant lr."""
    return torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def bert_optimizer(model: nn.Module, lr: float = 8e-4, weight_decay: float = 1e-5):
    """The ``examples/bert`` optimizer after its clip: optax's ``adamw`` (betas
    0.9/0.999, eps 1e-8, decoupled decay scaled by lr) at a constant lr,
    decaying every parameter, biases and norms included."""
    return torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def mlm_loss(logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = -100):
    """The ``examples/bert`` masked-LM loss: (cross-entropy, {"accuracy"}),
    each the mean over the positions whose label is not ``ignore_index``."""
    return (cross_entropy(logits, labels, ignore_index),
            {"accuracy": accuracy(logits.detach(), labels, ignore_index)})


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer, scheduler=None,
                    clip: float = 1.0, loss_fn: Callable = cross_entropy,
                    grad_shardings=None, opt_shardings=None, mesh=None):
    """Returns step(x, y) -> {"loss", "grad_norm"} (device tensors, not
    synchronised): forward, ``loss_fn(logits, y)``, backward, clip the
    gradients' global norm to ``clip`` (``math.inf``: no clip), optimizer
    step, schedule step. The caller picks ``model.train()`` (dropout on) or
    ``eval()``. A ``loss_fn`` that returns (loss, metrics), as ``mlm_loss``
    does, adds its metrics to the result. Under a sequence mesh x and y are
    the rank's chunks and "loss" is the global mean over every rank's tokens.

    Data parallelism: on a ``mesh`` with a ``"dp"`` dimension (taken from
    the shardings when they are given) x and y are this rank's shard of the
    batch; the gradients are averaged over dp and "loss" is the mean of the
    dp ranks' losses (the global mean when the shards are of one size).
    ``grad_shardings`` (``parallel.mesh.zero2_shardings``, {parameter name:
    Sharding}) makes it ZeRO-2: a gradient it splits is reduce-scattered over
    dp, and the rank keeps only its shard. ``opt_shardings``
    (``zero1_shardings``; ``grad_shardings`` when not given) is ZeRO-1: the
    optimizer steps this rank's shard of each parameter it splits, so its
    moments take the shard's shape, and the updated shards are all-gathered
    back into the parameter. Parameters split by ``shard_parameters`` (tensor
    or expert parallelism) count once in the clip's norm, summed over the
    ranks that hold their shards."""
    group = seq_group(model)
    dp = _DataParallel.build(model, optimizer, mesh, grad_shardings, opt_shardings)

    def step(x: torch.Tensor, y: torch.Tensor) -> dict[str, torch.Tensor]:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model(x), y)
        loss, metrics = loss if isinstance(loss, tuple) else (loss, {})
        if group is None:
            loss.backward()
        else:
            loss = seq_backward(model, loss, y.numel(), group)
        if dp is None:
            grad_norm = clip_grad_norm([([p for p in model.parameters() if p.grad is not None],
                                         ())], clip)
        else:
            loss = dp.average(loss.detach())
            grad_norm = dp.reduce_and_clip(clip)
        optimizer.step()
        if dp is not None:
            dp.gather_params()
        if scheduler is not None:
            scheduler.step()
        return {"loss": loss.detach(), "grad_norm": grad_norm, **metrics}

    return step


def clip_grad_norm(parts, clip: float) -> torch.Tensor:
    """``torch.nn.utils.clip_grad_norm_`` over parameters some of whose
    gradients are shards. ``parts``: [(parameters, the process groups over
    which their gradients are split)]; each part's norm is summed in squares
    over its groups, the parts' norms combine as ``clip_grad_norm_`` combines
    its tensors', and every gradient is scaled by min(1, clip / (norm +
    1e-6)). A single part split over nothing is ``clip_grad_norm_`` itself.
    Returns the norm before the clip."""
    norms = []
    for params, split in parts:
        norm = torch.nn.utils.get_total_norm([p.grad for p in params])
        if split:
            sq = norm.float().square()
            for grp in split:
                dist.all_reduce(sq, group=grp)
            norm = sq.sqrt()
        norms.append(norm)
    norm = norms[0] if len(norms) == 1 else torch.linalg.vector_norm(
        torch.stack([n.float() for n in norms]))
    torch.nn.utils.clip_grads_with_norm_([p for params, _ in parts for p in params], clip, norm)
    return norm


DP_AXIS = "dp"  # the mesh dimension that splits the batch
BUCKET_BYTES = 1 << 28  # the most one gradient collective carries


class _DataParallel:
    """The dp side of a train step: gradient averaging or reduce-scattering
    over the dp group, ZeRO shards of the parameters in the optimizer, the
    clip over sharded gradients, and the all-gather of updated shards. The
    gradients travel in flat buckets of at most BUCKET_BYTES, one collective
    a bucket; a dp group of one rank calls none."""

    def __init__(self, model, optimizer, mesh, grad_dims, opt_dims):
        self.group = mesh.get_group(DP_AXIS) if DP_AXIS in mesh.mesh_dim_names else None
        self.size = dist.get_world_size(self.group) if self.group is not None else 1
        self.rank = dist.get_rank(self.group) if self.group is not None else 0
        self.params = dict(model.named_parameters())
        self.grad_dims, self.opt_dims = grad_dims, opt_dims
        # ZeRO-1: the optimizer steps a leaf holding this rank's shard
        self.shards = {}
        for name, d in opt_dims.items():
            if self.size > 1:
                p = self.params[name]
                self.shards[name] = self._cut(p.detach(), d).clone().requires_grad_()
        swap = {id(self.params[n]): s for n, s in self.shards.items()}
        for g in optimizer.param_groups:
            g["params"] = [swap.get(id(p), p) for p in g["params"]]
        for name, shard in self.shards.items():
            state = optimizer.state.pop(self.params[name], None)
            if state:
                optimizer.state[shard] = {
                    k: self._cut(v, opt_dims[name]).clone()
                    if torch.is_tensor(v) and v.shape == self.params[name].shape else v
                    for k, v in state.items()}
        # the groups of more than one rank over which each parameter's
        # tensor- or expert-parallel shards lie
        self.split_over = {name: [g for g in (p.sharding.mesh.get_group(a) for _, a in
                                              p.sharding.sharded_dims())
                                  if dist.get_world_size(g) > 1]
                           for name, p in self.params.items()
                           if getattr(p, "sharding", None) is not None}

    @classmethod
    def build(cls, model, optimizer, mesh, grad_shardings, opt_shardings):
        if opt_shardings is None:
            opt_shardings = grad_shardings
        for shardings in (grad_shardings, opt_shardings):
            if mesh is None and shardings:
                mesh = next(iter(shardings.values())).mesh
        if mesh is None:
            return None

        def dims(shardings):
            out = {}
            for name, s in (shardings or {}).items():
                d = [d for d, a in s.sharded_dims() if a == DP_AXIS]
                if d:
                    out[name] = d[0]
            return out

        grad_dims, opt_dims = dims(grad_shardings), dims(opt_shardings)
        if any(opt_dims.get(n) != d for n, d in grad_dims.items()):
            raise ValueError("a gradient is split over dp on another dim than its moments")
        return cls(model, optimizer, mesh, grad_dims, opt_dims)

    def _cut(self, t, d):
        return t.chunk(self.size, dim=d)[self.rank]

    def average(self, loss):
        if self.size == 1:
            return loss
        loss = loss.clone()
        dist.all_reduce(loss, group=self.group)
        return loss / self.size

    @staticmethod
    def _buckets(grads):
        """Runs of indices into ``grads``, each of one dtype and at most
        BUCKET_BYTES (a larger tensor alone)."""
        runs, size = [], 0
        for i, g in enumerate(grads):
            if not runs or grads[runs[-1][0]].dtype != g.dtype or size + g.nbytes > BUCKET_BYTES:
                runs.append([])
                size = 0
            runs[-1].append(i)
            size += g.nbytes
        return runs

    def _all_reduce_mean(self, grads):
        """Each gradient replaced in place by its mean over dp."""
        for run in self._buckets(grads):
            flat = torch.cat([grads[i].reshape(-1) for i in run])
            dist.all_reduce(flat, group=self.group)
            flat.div_(self.size)
            for i, part in zip(run, flat.split([grads[i].numel() for i in run])):
                grads[i].copy_(part.view_as(grads[i]))

    def _reduce_scatter_mean(self, grads, dims):
        """This rank's shard (chunk ``rank`` of dim ``dims[i]``) of each
        gradient's mean over dp. A bucket is laid out (P, the shards' sizes
        summed), its row r the r-th chunk of every gradient, and one
        reduce-scatter leaves row ``rank`` here."""
        out = [None] * len(grads)
        for run in self._buckets(grads):
            moved = [grads[i].movedim(dims[i], 0) for i in run]
            rows = [g.reshape(self.size, -1) for g in moved]
            flat = torch.cat(rows, dim=1).reshape(-1)
            mine = flat.new_empty(flat.numel() // self.size)
            dist.reduce_scatter_tensor(mine, flat, group=self.group)
            mine.div_(self.size)
            for i, g, part in zip(run, moved, mine.split([r.shape[1] for r in rows])):
                out[i] = part.view(g.shape[0] // self.size, *g.shape[1:]).movedim(0, dims[i])
        return out

    def reduce_and_clip(self, clip):
        """Average the gradients over dp into the tensors the optimizer steps,
        then scale them to a global norm of at most ``clip``; returns the
        norm before the clip."""
        names = [n for n, p in self.params.items() if p.grad is not None]
        if self.size > 1:
            scatter = [n for n in names if n in self.grad_dims]
            shards = self._reduce_scatter_mean([self.params[n].grad for n in scatter],
                                               [self.grad_dims[n] for n in scatter])
            for name, g in zip(scatter, shards):
                self.shards[name].grad, self.params[name].grad = g, None
            self._all_reduce_mean([self.params[n].grad for n in names if n not in self.grad_dims])
            for name in names:
                if name in self.shards and name not in self.grad_dims:
                    p = self.params[name]
                    self.shards[name].grad = self._cut(p.grad, self.opt_dims[name]).contiguous()
                    p.grad = None
        parts = {}  # the groups a gradient is split over -> the tensors the optimizer steps
        for name in names:
            split = list(self.split_over.get(name, []))
            target = self.params[name]
            if name in self.shards:
                target = self.shards[name]
                split.append(self.group)
            parts.setdefault(tuple(id(g) for g in split), ([], split))[0].append(target)
        return clip_grad_norm(list(parts.values()), clip)

    def gather_params(self):
        """Every dp rank's updated shard, back into the whole parameter."""
        with torch.no_grad():
            for name, shard in self.shards.items():
                d = self.opt_dims[name]
                parts = [torch.empty_like(shard) for _ in range(self.size)]
                dist.all_gather(parts, shard.detach().contiguous(), group=self.group)
                self.params[name].copy_(torch.cat(parts, dim=d))


def make_eval_step(model: nn.Module):
    """Returns the classification eval step(batch) for ``batch = (x, y)`` or
    ``(x, y, w)``, y (B,) labels and ``w`` a 0/1 weight per row masking
    padded rows out of the counts: {"loss", "correct", "total"}, with
    dropout off, as the JAX package's ``make_eval_step`` with
    ``deterministic=True``."""

    @torch.no_grad()
    def step(batch) -> dict[str, torch.Tensor]:
        x, y, *rest = batch
        w = rest[0].float() if rest else torch.ones(y.shape[0], device=y.device)
        was_training = model.training
        model.eval()
        try:
            logits = model(x).float()
        finally:
            model.train(was_training)
        nll = torch.logsumexp(logits, dim=-1) - logits.gather(-1, y[..., None])[..., 0]
        return {
            "loss": (nll * w).sum() / w.sum().clamp(min=1.0),
            "correct": ((logits.argmax(-1) == y).float() * w).sum(),
            "total": w.sum(),
        }

    return step


@dataclasses.dataclass
class TrainState:
    """What a training run resumes from: the update count, the module, its
    optimizer and the optimizer's scheduler (None for a constant lr)."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler | None = None


def create_train_state(model: nn.Module, optimizer: torch.optim.Optimizer,
                       scheduler=None) -> TrainState:
    return TrainState(step=0, model=model, optimizer=optimizer, scheduler=scheduler)


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    """A numpy array on ``device``; integer arrays as int64, torch's index
    dtype (a gather or a one-hot takes no other)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if not (t.is_floating_point() or t.is_complex() or t.dtype == torch.bool):
        t = t.long()
    return t.to(device)


def evaluate(eval_step, arrays, batch_size: int, device="cuda"):
    """Run ``eval_step`` (``make_eval_step``'s, or one of the same contract)
    over every row of ``arrays`` (a tuple of numpy arrays sharing their
    leading axis, e.g. ``(val_x, val_y)``), returning ``(correct, total)`` as
    Python floats.

    Every batch has ``batch_size`` rows, on ``device`` (integer arrays as
    int64): the last partial one is padded with copies of its first row,
    which the step's 0/1 weight masks out of the counts. Raises on an empty
    split, where a loop over whole batches alone would count nothing and
    report 0% as a measurement."""
    n = len(arrays[-1])
    if n == 0:
        raise ValueError("evaluate(): empty eval split")
    correct = total = 0.0
    for i in range(0, n, batch_size):
        rows = [np.asarray(a[i : i + batch_size]) for a in arrays]
        w = np.ones(len(rows[-1]), np.float32)
        if len(w) < batch_size:
            pad = batch_size - len(w)
            rows = [np.concatenate([r, np.repeat(r[:1], pad, axis=0)]) for r in rows]
            w = np.concatenate([w, np.zeros(pad, np.float32)])
        batch = tuple(_to_device(r, device) for r in rows + [w])
        m = eval_step(batch)
        correct += float(m["correct"])
        total += float(m["total"])
    if total <= 0:
        raise AssertionError("evaluate(): zero rows counted")
    return correct, total


CHECKPOINT_FILE = "state.pt"


def save_checkpoint(path: str, state: TrainState, extra: dict | None = None) -> None:
    """Write ``state`` (module, optimizer and scheduler state dicts, and the
    step) and ``extra`` into the directory ``path``, replacing a checkpoint
    that is there. The directory is written under a temporary name beside
    it and renamed into place, so ``path`` holds either the old checkpoint
    or the whole new one."""
    path = os.path.abspath(path)
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=os.path.basename(path) + ".tmp-", dir=parent)
    try:
        torch.save({
            "step": state.step,
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "scheduler": None if state.scheduler is None else state.scheduler.state_dict(),
            "extra": extra,
        }, os.path.join(tmp, CHECKPOINT_FILE))
        old = None
        if os.path.exists(path):
            old = tempfile.mkdtemp(prefix=os.path.basename(path) + ".old-", dir=parent)
            os.replace(path, os.path.join(old, "ckpt"))
        os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if old is not None:
        shutil.rmtree(old, ignore_errors=True)


def restore_checkpoint(path: str, state: TrainState, extra: dict | None = None):
    """Load the checkpoint at ``path`` into ``state`` in place (tensors onto
    the device of the module's first parameter) and return ``(state,
    extra)``: the saved ``extra``, or None when the caller passes none."""
    device = next(state.model.parameters()).device
    ckpt = torch.load(os.path.join(path, CHECKPOINT_FILE), map_location=device,
                      weights_only=True)
    state.model.load_state_dict(ckpt["model"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    if state.scheduler is not None:
        state.scheduler.load_state_dict(ckpt["scheduler"])
    state.step = int(ckpt["step"])
    return state, (ckpt["extra"] if extra is not None else None)


AUTO_SAVE_NAME = "auto_save"


class auto_save_on_exception:
    """Save an emergency checkpoint when the training loop dies.

    Usage::

        guard = auto_save_on_exception(ckpt_dir)
        with guard:
            for batch in loader:
                metrics = train_step(*batch)
                guard.track(state, extra={"epoch": epoch})

    On an exception (KeyboardInterrupt included) the last tracked state, as
    it stands then, is written to <ckpt_dir>/auto_save and the exception
    propagates; a failure to save is printed and does not hide it. Pair with
    ``latest_checkpoint`` on resume, which prefers the newer of the regular
    and the auto-saved checkpoint."""

    def __init__(self, ckpt_dir: str):
        self.path = os.path.abspath(os.path.join(ckpt_dir, AUTO_SAVE_NAME))
        self._state = None
        self._extra = None

    def track(self, state: TrainState, extra: dict | None = None) -> None:
        self._state = state
        self._extra = extra

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None and self._state is not None:
            try:
                save_checkpoint(self.path, self._state, self._extra)
                print(f"auto-saved checkpoint to {self.path}", flush=True)
            except Exception as save_err:  # don't mask the original exception
                print(f"auto-save failed: {save_err!r}", flush=True)
        return False


def latest_checkpoint(ckpt_dir: str, name: str = "last") -> str | None:
    """Path of the newest checkpoint in ckpt_dir, preferring the auto-save
    when it is more recent than the regular one."""
    candidates = []
    for n in (name, AUTO_SAVE_NAME):
        p = os.path.abspath(os.path.join(ckpt_dir, n))
        if os.path.isdir(p):
            candidates.append((os.path.getmtime(p), p))
    return max(candidates)[1] if candidates else None


class ProgressiveResizing:
    """Sequence-resolution curriculum over training epochs.

    ``stage_params`` is a list like ``[{"resolution": 4, "epochs": 50},
    {"resolution": 2, "epochs": 30}, {"resolution": 1, "epochs": 20}]``, each
    stage optionally with ``"bandlimit"`` and ``"lr_scale"``. The train loop
    asks ``stage_of(epoch)`` each epoch, subsamples its batches with
    ``downsample(x, epoch)`` and rebuilds what depends on the length when
    ``boundary(epoch)`` is True. ``stage_of`` is a function of the epoch
    alone, so a resumed run lands in the right stage."""

    def __init__(self, stage_params: list[dict]):
        if not stage_params:
            raise ValueError("No stages specified")
        if not all({"resolution", "epochs"} <= set(s) for s in stage_params):
            raise ValueError("stage_params must contain keys: resolution and epochs")
        self.stage_params = list(stage_params)
        self._cume = []
        tot = 0
        for s in stage_params:
            tot += s["epochs"]
            self._cume.append(tot)
        self.total_epochs = tot

    def stage_of(self, epoch: int) -> int:
        for i, hi in enumerate(self._cume):
            if epoch < hi:
                return i
        return len(self.stage_params) - 1

    def boundary(self, epoch: int) -> bool:
        """True when ``epoch`` starts a new stage."""
        return epoch == 0 or any(epoch == hi for hi in self._cume[:-1])

    def params_at(self, epoch: int) -> dict:
        return self.stage_params[self.stage_of(epoch)]

    def downsample(self, x, epoch: int):
        """Subsample the sequence axis (axis 1 of (B, L, ...) or (B, L)) by
        the stage's resolution."""
        r = int(self.params_at(epoch)["resolution"])
        return x if r == 1 else x[:, ::r]

    def lr_scale(self, epoch: int) -> float:
        return float(self.params_at(epoch).get("lr_scale", 1.0))

    def bandlimit(self, epoch: int):
        return self.params_at(epoch).get("bandlimit")
