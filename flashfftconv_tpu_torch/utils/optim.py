"""Optimizer construction with per-parameter groups, schedules and EMA (PyTorch).

Port of the JAX package's ``utils/optim.py``. The JAX package labels each
leaf of the flax parameter tree ('special' for conv-kernel parameters,
'default' otherwise) and gives each label its own optax AdamW. The port
labels each parameter by its flax path (``jax_weights.flax_paths``, the
inverse of the weight-import key map), never by its PyTorch name: a flax
Dense ``kernel`` and a LayerNorm ``scale`` are both ``.weight`` here.

The schedules are optax's, as functions of the update count (0 for the
first update); ``lr_lambda`` turns one into a ``LambdaLR`` factor, so the
first ``optimizer.step()`` runs at ``schedule(0)``, as optax's does.
``torch.optim.AdamW`` with betas (0.9, 0.999) and eps 1e-8 is optax's
``adamw``: the decay is decoupled and scaled by the learning rate.

Every schedule the JAX registry names (constant, linear, cosine,
warmup-cosine, exponential, warmup-exponential, sgdr, piecewise) is here
with optax's arguments and values, and so are optax's ``adamw``, ``adam``,
``sgd`` and ``lamb`` by their optax keywords, defaults and options, each on
a torch optimizer of the port's own with optax's update rule (``Adam``,
``Sgd``, ``Lamb``), for ``utils.registry``.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
from torch import nn

from flashfftconv_tpu_torch.utils import jax_weights


def constant_schedule(value: float):
    """optax.constant_schedule."""
    return lambda step: value


def linear_schedule(init_value: float, end_value: float, transition_steps: int,
                    transition_begin: int = 0):
    """optax.linear_schedule: init before transition_begin, then linearly to
    end over transition_steps, then end; init throughout when
    transition_steps <= 0."""
    if transition_steps <= 0:
        return lambda step: init_value
    begin = max(transition_begin, 0)

    def f(step: int) -> float:
        frac = 1.0 - min(max(step - begin, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value

    return f


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0,
                          exponent: float = 1.0):
    """optax.cosine_decay_schedule: init * ((1 - alpha) * cosine**exponent + alpha)."""
    if decay_steps <= 0:
        raise ValueError(f"decay_steps must be positive, got {decay_steps}")

    def f(step: int) -> float:
        cosine = 0.5 * (1 + math.cos(math.pi * min(step, decay_steps) / decay_steps))
        return init_value * ((1 - alpha) * cosine**exponent + alpha)

    return f


def _join(schedules, boundaries):
    """optax.join_schedules: schedule i + 1 from boundary i on, counted from it."""

    def f(step: int) -> float:
        for boundary, schedule in zip(boundaries[::-1], schedules[:0:-1]):
            if step >= boundary:
                return schedule(step - boundary)
        return schedules[0](step)

    return f


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0,
                                 exponent: float = 1.0):
    """optax.warmup_cosine_decay_schedule: linear warmup to the peak, then a
    cosine decay over the remaining decay_steps - warmup_steps."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    return _join([linear_schedule(init_value, peak_value, warmup_steps),
                  cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha,
                                        exponent)], [warmup_steps])


def exponential_decay(init_value: float, transition_steps: int, decay_rate: float,
                      transition_begin: int = 0, staircase: bool = False,
                      end_value: float | None = None):
    """optax.exponential_decay: init * decay_rate ** ((step - begin) /
    transition_steps) from transition_begin on (the exponent floored when
    ``staircase``), bounded by ``end_value`` (below when decay_rate < 1)."""
    if transition_steps <= 0 or decay_rate == 0:
        return lambda step: init_value
    begin = max(transition_begin, 0)
    clip = max if decay_rate < 1.0 else min

    def f(step: int) -> float:
        if step - begin <= 0:
            value = init_value
        else:
            p = (step - begin) / transition_steps
            value = init_value * decay_rate ** (math.floor(p) if staircase else p)
        return value if end_value is None else clip(value, end_value)

    return f


def warmup_exponential_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                      transition_steps: int, decay_rate: float,
                                      transition_begin: int = 0, staircase: bool = False,
                                      end_value: float | None = None):
    """optax.warmup_exponential_decay_schedule: linear warmup to the peak,
    then ``exponential_decay`` from it."""
    return _join([linear_schedule(init_value, peak_value, warmup_steps),
                  exponential_decay(peak_value, transition_steps, decay_rate, transition_begin,
                                    staircase, end_value)], [warmup_steps])


def sgdr_schedule(cosine_kwargs):
    """optax.sgdr_schedule: warmup-cosine cycles one after another, each
    ``decay_steps`` long, from the keyword dicts of ``cosine_kwargs``."""
    schedules, boundaries, step = [], [], 0
    for kwargs in cosine_kwargs:
        schedules.append(warmup_cosine_decay_schedule(**kwargs))
        step += kwargs["decay_steps"]
        boundaries.append(step)
    return _join(schedules, boundaries[:-1])


def piecewise_constant_schedule(init_value: float, boundaries_and_scales: dict | None = None):
    """optax.piecewise_constant_schedule: init times the scales of every
    boundary the step has reached."""
    items = sorted((boundaries_and_scales or {}).items())
    if any(scale < 0.0 for _, scale in items):
        raise ValueError("piecewise_constant_schedule expects non-negative scale factors")

    def f(step: int) -> float:
        value = init_value
        for boundary, scale in items:
            if step >= boundary:
                value *= scale
        return value

    return f


def lr_lambda(schedule, base_lr: float):
    """The ``LambdaLR`` factor that makes a group of base lr ``base_lr``
    follow ``schedule``."""
    return lambda step: 0.0 if base_lr == 0.0 else schedule(step) / base_lr


def kernel_label_fn(path: tuple[str, ...]) -> bool:
    """True for long-conv kernel parameters (the reference's ``_optim``
    params): every flax leaf named ``kernel``, as the JAX package marks them."""
    return any(n == "kernel" for n in path)


def label_params(model: nn.Module, is_special: Callable = kernel_label_fn) -> dict[str, str]:
    """'special' or 'default' for each parameter name, from its flax path."""
    paths = jax_weights.flax_paths(model)
    return {name: "special" if is_special(paths[name]) else "default"
            for name, _ in model.named_parameters()}


def make_optimizer(
    model: nn.Module,
    lr: float = 1e-3,
    weight_decay: float = 0.05,
    special_lr: float | None = 1e-3,
    epochs: int | None = None,
    steps_per_epoch: int | None = None,
    warmup_steps: int = 0,
    is_special: Callable = kernel_label_fn,
):
    """AdamW with a no-weight-decay group for kernel params and an optional
    (warmup +) cosine schedule, as the JAX package's ``make_optimizer``.
    Returns (optimizer, scheduler); call ``scheduler.step()`` after each
    ``optimizer.step()``. Group 0 is 'default', group 1 'special'."""

    def sched(base):
        if epochs is None or steps_per_epoch is None:
            if not warmup_steps:
                return lambda step: base
            return linear_schedule(0.0, base, warmup_steps)
        total = epochs * steps_per_epoch
        if not warmup_steps:
            return cosine_decay_schedule(base, total)
        return warmup_cosine_decay_schedule(0.0, base, warmup_steps,
                                            max(total, warmup_steps + 1))

    labels = label_params(model, is_special)
    special_lr = special_lr if special_lr is not None else lr
    groups = [
        {"params": [p for n, p in model.named_parameters() if labels[n] == label],
         "lr": group_lr, "weight_decay": wd}
        for label, group_lr, wd in (("default", lr, weight_decay), ("special", special_lr, 0.0))
    ]
    opt = torch.optim.AdamW(groups, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        opt, [lr_lambda(sched(lr), lr), lr_lambda(sched(special_lr), special_lr)])
    return opt, scheduler


@torch.no_grad()
def ema_init(model: nn.Module) -> dict[str, torch.Tensor]:
    """EMA of parameters (the reference harness's EMACallback): an f32
    shadow copy by name."""
    return {n: p.detach().float().clone() for n, p in model.named_parameters()}


@torch.no_grad()
def ema_update(ema: dict[str, torch.Tensor], model: nn.Module, decay: float = 0.999):
    """One EMA step in place: shadow <- decay * shadow + (1 - decay) * params."""
    for n, p in model.named_parameters():
        ema[n].mul_(decay).add_(p.detach().float(), alpha=1.0 - decay)
    return ema


def ema_swap(ema: dict[str, torch.Tensor], model: nn.Module) -> dict[str, torch.Tensor]:
    """The shadow params at the live params' dtypes, for
    ``model.load_state_dict(..., strict=False)`` before an eval."""
    return {n: ema[n].to(p.dtype) for n, p in model.named_parameters()}


# optax's optimizers by their keyword names, for configs that carry over from
# the JAX package (utils.registry kind "optimizer"). Each takes the parameters
# and returns (optimizer, scheduler): a ``learning_rate`` that is a schedule
# (a step -> value callable) becomes a LambdaLR over a base lr of 1, so the
# k-th update runs at schedule(k); a number gives scheduler None. The
# defaults are optax's, not torch's (optax.adamw decays by 1e-4, torch's
# AdamW by 1e-2), and so is every option optax 0.2.6 takes, with optax's
# update rules (``Adam``, ``Lamb``, ``Sgd``):
#   - a dtype (``mu_dtype``, ``accumulator_dtype``) is a torch dtype or its
#     name ("bfloat16", as a registry config carries it);
#   - a ``mask`` (adamw, lamb) says which parameters decay, as optax's tree
#     of booleans does: here a sequence of bools aligned with the parameters
#     in the order given (across param groups), or a callable that takes
#     that list of tensors and returns one. The parameters it leaves out go
#     to param groups of their own with weight_decay 0.


def _lr_and_scheduler(learning_rate):
    if callable(learning_rate):
        return 1.0, learning_rate
    return float(learning_rate), None


def _with_schedule(opt: torch.optim.Optimizer, schedule):
    if schedule is None:
        return opt, None
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, lr_lambda(schedule, 1.0))


def _dtype(value) -> torch.dtype | None:
    """None, a torch dtype, or a torch dtype's name."""
    if value is None or isinstance(value, torch.dtype):
        return value
    dt = getattr(torch, str(value), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"{value!r} names no torch dtype")
    return dt


def _masked_groups(params, mask) -> list[dict]:
    """``params`` (tensors or param groups) as param groups, each split into
    the parameters ``mask`` decays and those it does not (weight_decay 0)."""
    params = list(params)
    groups = params if params and isinstance(params[0], dict) else [{"params": params}]
    groups = [{**g, "params": list(g["params"])} for g in groups]
    if mask is None:
        return groups
    flat = [p for g in groups for p in g["params"]]
    keep = mask(flat) if callable(mask) else mask
    if isinstance(keep, (dict, str)) or len(keep) != len(flat):
        raise ValueError(f"mask must give one bool for each of the {len(flat)} parameters, "
                         f"in order")
    keep, out = iter(keep), []
    for g in groups:
        flags = [bool(next(keep)) for _ in g["params"]]
        decayed = [p for p, k in zip(g["params"], flags) if k]
        kept = [p for p, k in zip(g["params"], flags) if not k]
        if decayed:
            out.append({**g, "params": decayed})
        if kept:
            out.append({**g, "params": kept, "weight_decay": 0.0})
    return out


def _times(t: torch.Tensor, decay: float) -> torch.Tensor:
    """decay * t with decay rounded to t's dtype first, as JAX's weakly typed
    scalar is (a bf16 moment: bf16(0.9) * t, rounded to bf16)."""
    return t * float(torch.tensor(decay, dtype=t.dtype))


def _debias(t: torch.Tensor, decay: float, count: int) -> torch.Tensor:
    """optax's bias_correction: t / (1 - decay**count), the divisor in f32."""
    return t / (1 - torch.tensor(decay, dtype=torch.float32) ** count).to(t.dtype)


class Adam(torch.optim.Optimizer):
    """optax's ``scale_by_adam``, then ``add_decayed_weights``, then the lr:
    mu = (1 - b1) g + b1 mu and nu = (1 - b2) g^2 + b2 nu; mu_hat = mu /
    (1 - b1^t) (with ``nesterov``, b1 mu / (1 - b1^(t+1)) + (1 - b1) g /
    (1 - b1^t)), nu_hat = nu / (1 - b2^t); u = mu_hat / (sqrt(nu_hat +
    eps_root) + eps) + weight_decay * param; param -= lr u. mu is kept at
    ``mu_dtype`` between steps (computed at the gradient's dtype), nu at the
    parameter's. Each group's weight_decay applies to its parameters alone
    (``_masked_groups``)."""

    trust_ratio = False

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 eps_root: float = 0.0, weight_decay: float = 0.0, mu_dtype=None,
                 nesterov: bool = False):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, eps_root=eps_root,
                                      weight_decay=weight_decay, mu_dtype=_dtype(mu_dtype),
                                      nesterov=nesterov))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g, state = p.grad, self.state[p]
                if not state:
                    state["step"] = 0
                    state["mu"] = torch.zeros_like(p, dtype=group["mu_dtype"] or p.dtype)
                    state["nu"] = torch.zeros_like(p)
                state["step"] += 1
                t = state["step"]
                mu = g * (1.0 - b1) + _times(state["mu"], b1)
                nu = g * g * (1.0 - b2) + _times(state["nu"], b2)
                if group["nesterov"]:
                    mu_hat = _debias(mu, b1, t + 1) * b1 + _debias(g, b1, t) * (1.0 - b1)
                else:
                    mu_hat = _debias(mu, b1, t)
                update = mu_hat / ((_debias(nu, b2, t) + group["eps_root"]).sqrt() + group["eps"])
                state["mu"], state["nu"] = mu.to(state["mu"].dtype), nu
                if group["weight_decay"]:
                    update += p * group["weight_decay"]
                if self.trust_ratio:
                    p_norm, u_norm = p.norm(), update.norm()
                    update *= torch.where((p_norm == 0) | (u_norm == 0), 1.0, p_norm / u_norm)
                p.add_(update, alpha=-group["lr"])
        return loss


class Lamb(Adam):
    """optax.lamb: ``Adam``'s update (without mu_dtype or nesterov) scaled by
    each parameter's trust ratio ||param|| / ||update|| (1 where either norm
    is 0), times -lr."""

    trust_ratio = True

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-6,
                 eps_root: float = 0.0, weight_decay: float = 0.0):
        super().__init__(params, lr, betas=betas, eps=eps, eps_root=eps_root,
                         weight_decay=weight_decay)


class Sgd(torch.optim.Optimizer):
    """optax.sgd: param -= lr g; with a ``momentum``, optax's trace t = g +
    momentum t (kept at ``accumulator_dtype`` between steps, the product at
    its dtype as in ``Adam``) and param -= lr t, or lr (g + momentum t) with
    ``nesterov``."""

    def __init__(self, params, lr: float, momentum: float | None = None,
                 nesterov: bool = False, accumulator_dtype=None):
        super().__init__(params, dict(lr=lr, momentum=momentum, nesterov=nesterov,
                                      accumulator_dtype=_dtype(accumulator_dtype)))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            m = group["momentum"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if m is None:
                    p.add_(g, alpha=-group["lr"])
                    continue
                state = self.state[p]
                if not state:
                    state["trace"] = torch.zeros_like(
                        p, dtype=group["accumulator_dtype"] or p.dtype)
                trace = g + _times(state["trace"], m)
                update = g + trace * m if group["nesterov"] else trace
                state["trace"] = trace.to(state["trace"].dtype)
                p.add_(update, alpha=-group["lr"])
        return loss


def adamw(params, learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          eps_root: float = 0.0, mu_dtype=None, weight_decay: float = 1e-4, mask=None, *,
          nesterov: bool = False):
    """optax.adamw: ``Adam`` with the decay decoupled and scaled by the lr,
    on the parameters ``mask`` selects (all by default)."""
    lr, schedule = _lr_and_scheduler(learning_rate)
    return _with_schedule(Adam(_masked_groups(params, mask), lr=lr, betas=(b1, b2), eps=eps,
                               eps_root=eps_root, weight_decay=weight_decay,
                               mu_dtype=mu_dtype, nesterov=nesterov), schedule)


def adam(params, learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         eps_root: float = 0.0, mu_dtype=None, *, nesterov: bool = False):
    """optax.adam (``Adam`` without decay)."""
    lr, schedule = _lr_and_scheduler(learning_rate)
    return _with_schedule(Adam(params, lr=lr, betas=(b1, b2), eps=eps, eps_root=eps_root,
                               mu_dtype=mu_dtype, nesterov=nesterov), schedule)


def sgd(params, learning_rate, momentum: float | None = None, nesterov: bool = False,
        accumulator_dtype=None):
    """optax.sgd (``Sgd``): plain, or with a momentum trace (nesterov or not)."""
    lr, schedule = _lr_and_scheduler(learning_rate)
    return _with_schedule(Sgd(params, lr=lr, momentum=momentum, nesterov=nesterov,
                              accumulator_dtype=accumulator_dtype), schedule)


def lamb(params, learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
         eps_root: float = 0.0, weight_decay: float = 0.0, mask=None):
    """optax.lamb (``Lamb``), the decay on the parameters ``mask`` selects."""
    lr, schedule = _lr_and_scheduler(learning_rate)
    return _with_schedule(Lamb(_masked_groups(params, mask), lr=lr, betas=(b1, b2), eps=eps,
                               eps_root=eps_root, weight_decay=weight_decay), schedule)
