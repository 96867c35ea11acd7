"""Plain PyTorch reference of the Hyena causal LM, in float32.

The architecture of the Hyena paper (arXiv:2302.10866) as the H3/safari
``ConvLMHeadModel`` builds it, which is also HyenaDNA's: token embedding,
``n_layer`` pre-norm blocks (LayerNorm, Hyena operator, residual;
LayerNorm, GELU MLP, residual), a final LayerNorm and logits against the
tied embedding table. A Hyena operator of order 2 projects to three
streams, runs a causal depthwise conv of ``short_filter_order`` taps over
them, multiplies the value by the first gate, convolves it with the
implicit long filter (an MLP with sine activations over positional
features, under an exponential decay), adds the filter's skip term,
multiplies by the last gate and projects out.

Everything runs in float32 with TF32 off; the long convolution is a
zero-padded ``torch.fft`` product at FFT size ``2 * l_max``. The positional
features and the decay rates are worked out here from the configuration,
not taken from the program under test; the weights come from
``init_params``, which the benchmark also loads into the program.

``Rounding`` marks where the configuration computes in a lower precision
(its ``act_dtype``): the identity here, per-tensor-scaled float8 in
``Fp8Rounding``, the control of the output check. This file imports
nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

E4M3_MAX, E5M2_MAX = 448.0, 57344.0


def exact_math() -> None:
    """float32 matrix products in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Rounding:
    """Where the configuration rounds to its activation dtype: ``act`` on an
    activation, ``weight`` on a weight cast for a product. Identity: the
    float32 reference."""

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def weight(self, x: torch.Tensor) -> torch.Tensor:
        return x


def _fp8(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    scale = x.detach().abs().amax().float().clamp(min=1e-30) / top
    return ((x.float() / scale).to(dtype).float() * scale).to(x.dtype)


class _Fp8Round(torch.autograd.Function):
    """Forward rounded to e4m3, backward to e5m2, each with a per-tensor
    scale from its largest magnitude (the usual float8 training recipe)."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, E5M2_MAX)


class Fp8Rounding(Rounding):
    """The reference at the precision one step below bfloat16: every value
    that the configuration holds in bfloat16 is rounded to float8."""

    def act(self, x):
        return _Fp8Round.apply(x)

    def weight(self, x):
        return _Fp8Round.apply(x)


# --- the weights -------------------------------------------------------------


def padded_vocab(cfg: dict) -> int:
    v, m = cfg["vocab_size"], cfg["pad_vocab_size_multiple"]
    return v + (-v) % m


def param_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """Every parameter of the model by name, with its shape."""
    d, inner, order = cfg["d_model"], cfg["d_inner"], cfg["order"]
    f, e = cfg["filter_order"], cfg["emb_dim"]
    shapes = {"embeddings.weight": (padded_vocab(cfg), d)}
    for i in range(cfg["n_layer"]):
        p = f"backbone.blocks.{i}."
        shapes.update({
            p + "norm1.weight": (d,), p + "norm1.bias": (d,),
            p + "mixer.in_proj": ((order + 1) * d, d),
            p + "mixer.short_filter.weights": ((order + 1) * d, cfg["short_filter_order"]),
            p + "mixer.short_filter.bias": ((order + 1) * d,),
            p + "mixer.filter.bias": ((order - 1) * d,),
        })
        dims = [e] + [f] * (cfg["num_inner_mlps"] + 1)
        for j in range(cfg["num_inner_mlps"] + 1):
            shapes[p + f"mixer.filter.layers.{2 * j}.weight"] = (dims[j + 1], dims[j])
            shapes[p + f"mixer.filter.layers.{2 * j}.bias"] = (dims[j + 1],)
            shapes[p + f"mixer.filter.layers.{2 * j + 1}.freq"] = (1, f)
        last = 2 * (cfg["num_inner_mlps"] + 1)
        shapes[p + f"mixer.filter.layers.{last}.weight"] = ((order - 1) * d, f)
        shapes.update({
            p + "mixer.out_proj.weight": (d, d), p + "mixer.out_proj.bias": (d,),
            p + "norm2.weight": (d,), p + "norm2.bias": (d,),
            p + "mlp.fc1.weight": (inner, d), p + "mlp.fc1.bias": (inner,),
            p + "mlp.fc2.weight": (d, inner), p + "mlp.fc2.bias": (d,),
        })
    shapes["backbone.ln_f.weight"] = (d,)
    shapes["backbone.ln_f.bias"] = (d,)
    return shapes


def _init_kind(name: str) -> str:
    if name.endswith(".freq"):
        return "freq"
    if name.endswith("norm1.weight") or name.endswith("norm2.weight") or name.endswith(
            "ln_f.weight"):
        return "ones"
    if name.endswith("filter.bias"):
        return "unit_normal"  # the filter's skip term, N(0, 1) in the Hyena code
    if name.endswith(".bias"):
        return "zeros"
    if name.endswith("short_filter.weights"):
        return "uniform"
    return "fan_in_normal"


def init_params(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The weights of ``seed``, in float32 on ``device``, drawn in two calls
    (one normal, one uniform) from a generator on that device and cut per
    parameter: normal / sqrt(fan in) for matrices and the embedding, N(0, 1)
    for the filter's skip term, U(0, 2 / sqrt(channels)) for the short
    filter, the sine frequency ``filter_w``, ones and zeros for norms and
    biases."""
    shapes = param_shapes(cfg)
    kinds = {n: _init_kind(n) for n in shapes}
    count = lambda ks: sum(math.prod(shapes[n]) for n in shapes if kinds[n] in ks)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2**63))
    normal = torch.randn(count(("fan_in_normal", "unit_normal")), generator=gen, device=device)
    uniform = torch.rand(count(("uniform",)), generator=gen, device=device)
    out, at_n, at_u = {}, 0, 0
    for name, shape in shapes.items():
        n, kind = math.prod(shape), kinds[name]
        if kind in ("fan_in_normal", "unit_normal"):
            std = 1.0 if kind == "unit_normal" else 1.0 / math.sqrt(shape[-1])
            t = normal[at_n : at_n + n].view(shape) * std
            at_n += n
        elif kind == "uniform":
            t = uniform[at_u : at_u + n].view(shape) * (2.0 / math.sqrt(shape[0]))
            at_u += n
        elif kind == "freq":
            t = torch.full(shape, float(cfg["filter_w"]), device=device)
        elif kind == "ones":
            t = torch.ones(shape, device=device)
        else:
            t = torch.zeros(shape, device=device)
        out[name] = t
    return out


# --- the forward -------------------------------------------------------------


def positional_features(emb_dim: int, seq_len: int, device):
    """(z, t): z (L, emb_dim) = [t, cos(f w), -sin(f w)] with w = 2 pi
    i / L over ``(emb_dim - 1) / 2`` frequencies f from 1e-4 to bands - 1,
    t (L, 1) = i / (L - 1); computed in float64, returned in float32."""
    t = np.linspace(0, 1, seq_len)[:, None]
    bands = (emb_dim - 1) // 2
    w = 2 * math.pi * np.arange(seq_len)[:, None] / seq_len
    f = np.linspace(1e-4, bands - 1, bands)[None, :]
    z = np.concatenate([t, np.cos(f * w), -np.sin(f * w)], axis=-1)
    as_t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)
    return as_t(z), as_t(t)


def decay_rates(channels: int, cfg: dict, device) -> torch.Tensor:
    """|delta| of the exponential modulation, evenly spaced from
    log(target) / slow to log(target) / fast."""
    m = cfg["modulation"]
    lo = math.log(m["target"]) / m["slow_decay_pct"]
    hi = math.log(m["target"]) / m["fast_decay_pct"]
    return torch.from_numpy(np.abs(np.linspace(lo, hi, channels)).astype(np.float32)).to(device)


def implicit_filter(P: dict, pre: str, cfg: dict, length: int) -> torch.Tensor:
    """The long filter taps (channels, length) of one layer, float32."""
    z, t = positional_features(cfg["emb_dim"], cfg["l_max"], P[pre + "bias"].device)
    h = z[:length]
    n = cfg["num_inner_mlps"] + 1
    for j in range(n):
        h = h @ P[pre + f"layers.{2 * j}.weight"].T + P[pre + f"layers.{2 * j}.bias"]
        h = torch.sin(cfg["filter_w_mod"] * P[pre + f"layers.{2 * j + 1}.freq"] * h)
    h = h @ P[pre + f"layers.{2 * n}.weight"].T
    channels = h.shape[-1]
    h = h * (torch.exp(-t[:length] * decay_rates(channels, cfg, h.device))
             + cfg["modulation"]["shift"])
    return h.T


def long_conv(u: torch.Tensor, k: torch.Tensor, n_fft: int) -> torch.Tensor:
    """Causal convolution of u (B, H, L) with k (H, L), zero-padded to
    ``n_fft``: irfft(rfft(u) rfft(k))[..., :L]."""
    length = u.shape[-1]
    y = torch.fft.irfft(torch.fft.rfft(u, n=n_fft) * torch.fft.rfft(k, n=n_fft), n=n_fft)
    return y[..., :length]


def hyena(P: dict, pre: str, cfg: dict, u: torch.Tensor, rnd: Rounding) -> torch.Tensor:
    """One Hyena operator over u (B, L, D)."""
    b, length, d = u.shape
    order, taps = cfg["order"], cfg["short_filter_order"]
    x = rnd.act(torch.einsum("od,bld->bol", rnd.weight(P[pre + "in_proj"]), u))
    w = P[pre + "short_filter.weights"]
    x = rnd.act(F.conv1d(F.pad(x, (taps - 1, 0)), w[:, None, :], P[pre + "short_filter.bias"],
                         groups=w.shape[0]))
    *gates, v = x.split(d, dim=1)
    k = implicit_filter(P, pre + "filter.", cfg, length).reshape(order - 1, d, length)
    skip = P[pre + "filter.bias"].reshape(order - 1, d)
    low = True  # v is held in the activation dtype until the first skip term
    for o, gate in enumerate(reversed(gates[1:])):
        v = v * gate
        v = rnd.act(v) if low else v
        y = long_conv(v, k[o], 2 * cfg["l_max"])
        v = (rnd.act(y) if low else y) + skip[o][None, :, None] * v
        low = False
    y = (v * gates[0]).transpose(1, 2)
    return rnd.act(F.linear(rnd.act(y), rnd.weight(P[pre + "out_proj.weight"]),
                            rnd.weight(P[pre + "out_proj.bias"])))


def mlp(P: dict, pre: str, x: torch.Tensor, rnd: Rounding) -> torch.Tensor:
    h = rnd.act(F.linear(x, rnd.weight(P[pre + "fc1.weight"]), rnd.weight(P[pre + "fc1.bias"])))
    h = rnd.act(F.gelu(h, approximate="tanh"))
    return rnd.act(F.linear(h, rnd.weight(P[pre + "fc2.weight"]),
                            rnd.weight(P[pre + "fc2.bias"])))


def _norm(P: dict, pre: str, x: torch.Tensor, eps: float) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], P[pre + "weight"], P[pre + "bias"], eps)


def block(P: dict, i: int, cfg: dict, x: torch.Tensor, rnd: Rounding) -> torch.Tensor:
    p, eps = f"backbone.blocks.{i}.", cfg["layer_norm_eps"]
    res = x + hyena(P, p + "mixer.", cfg, rnd.act(_norm(P, p + "norm1.", x, eps)), rnd)
    res = res + mlp(P, p + "mlp.", rnd.act(_norm(P, p + "norm2.", res, eps)), rnd)
    return rnd.act(res)


def logits(P: dict, cfg: dict, ids: torch.Tensor, rnd: Rounding = Rounding(),
           remat: bool = False) -> torch.Tensor:
    """Logits (B, L, padded vocab), float32. ``remat`` recomputes each
    block in the backward (``torch.utils.checkpoint``), so that a long
    sequence's gradients fit."""
    table = P["embeddings.weight"]
    x = rnd.act(table[ids])
    for i in range(cfg["n_layer"]):
        if remat and torch.is_grad_enabled():
            x = checkpoint(block, P, i, cfg, x, rnd, use_reentrant=False)
        else:
            x = block(P, i, cfg, x, rnd)
    h = _norm(P, "backbone.ln_f.", x, cfg["layer_norm_eps"])
    return rnd.act(F.linear(rnd.act(h), rnd.weight(table)))


def token_nll(lg: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """-log p(target) at each position, float32."""
    return torch.logsumexp(lg, dim=-1) - lg.gather(-1, targets[..., None])[..., 0]


# --- the training recipe -----------------------------------------------------


def lr_at(recipe: dict, update: int) -> float:
    """The learning rate of update ``update`` (0 for the first): constant,
    or a linear warm-up from 0 over ``warmup`` updates followed by a cosine
    decay to 0 at ``steps``."""
    lr = recipe["lr"]
    if recipe["schedule"] == "constant":
        return lr
    warmup = min(recipe["warmup"], max(recipe["steps"] // 2, 1))
    total = max(recipe["steps"], warmup + 1)
    if update < warmup:
        return lr * update / warmup
    frac = min(update - warmup, total - warmup) / (total - warmup)
    return lr * 0.5 * (1 + math.cos(math.pi * frac))


def train_steps(P0: dict, cfg: dict, recipe: dict, batches, rnd: Rounding = Rounding(),
                rows: int = 1, remat: bool = False) -> dict:
    """Takes len(batches) steps of the recipe from the weights P0: the mean
    token cross-entropy over the whole batch (its gradient summed over
    blocks of ``rows`` rows), the gradients' global norm clipped to
    ``recipe["clip"]``, then AdamW (decay decoupled and scaled by the
    learning rate). Returns the losses, each leaf's clipped first gradient
    and its change over all the steps, by name."""
    params = {n: p.detach().clone().requires_grad_() for n, p in P0.items()}
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
    b1, b2 = recipe["betas"]
    losses, first_grad = [], None
    for t, (x, y) in enumerate(batches, start=1):
        total = x.new_zeros((), dtype=torch.float32)
        for lo in range(0, x.shape[0], rows):
            xs, ys = x[lo : lo + rows], y[lo : lo + rows]
            loss = token_nll(logits(params, cfg, xs, rnd, remat), ys).sum() / y.numel()
            loss.backward()
            total += loss.detach()
        losses.append(total)
        with torch.no_grad():
            grads = {n: p.grad for n, p in params.items()}
            norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g) for g in grads.values()]))
            scale = torch.clamp(recipe["clip"] / (norm + 1e-6), max=1.0)
            for g in grads.values():
                g.mul_(scale)
            if first_grad is None:
                first_grad = {n: torch.linalg.vector_norm(g) for n, g in grads.items()}
            lr = lr_at(recipe, t - 1)
            for n, p in params.items():
                g = grads[n]
                p.mul_(1 - lr * recipe["weight_decay"])
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v[n].sqrt() / math.sqrt(1 - b2**t)).add_(recipe["eps"])
                p.addcdiv_(m[n], denom, value=-lr / (1 - b1**t))
                p.grad = None
    with torch.no_grad():
        change = {n: torch.linalg.vector_norm(p - P0[n]) for n, p in params.items()}
    return {"losses": losses, "grad_norms": first_grad, "change_norms": change}


# --- the work a unit needs, from the shapes ----------------------------------


def work(cfg: dict, batch: int, length: int, train: bool) -> dict:
    """The model's FLOPs for one forward (``train``: a train step, three
    times that), and the least traffic and operations of every long
    convolution: each call's inputs read once and outputs written once
    (forward: u and k in, y out; backward: dy, u and k in, du and dk out),
    and its ``fftconv_algo_flops`` count, once forward and twice backward.
    Counted: every projection, the MLP and the LM head at 2 m n k, the
    implicit filter's MLP, the long convolutions. Recomputation is not."""
    from portbench.flops import fftconv_algo_flops, linear_flops

    d, order, f, e = cfg["d_model"], cfg["order"], cfg["filter_order"], cfg["emb_dim"]
    rows = batch * length
    n_fft = 2 * cfg["l_max"]
    act = 2 if cfg["act_dtype"] in ("bfloat16", "float16") else 4
    conv = fftconv_algo_flops(n_fft, batch, d)
    filt = (linear_flops(length, f, e) + cfg["num_inner_mlps"] * linear_flops(length, f, f)
            + linear_flops(length, (order - 1) * d, f))
    layer = (linear_flops(rows, (order + 1) * d, d) + linear_flops(rows, d, d)
             + 2 * linear_flops(rows, cfg["d_inner"], d) + filt + (order - 1) * conv)
    forward = cfg["n_layer"] * layer + linear_flops(rows, padded_vocab(cfg), d)
    calls = []
    for o in range(order - 1):
        io = act if o == 0 else 4  # after the first skip term v is float32
        bhl, hl = batch * d * length * io, d * length * 4
        calls.append({"phase": "forward", "bytes": 2 * bhl + hl, "flops": conv})
        if train:
            calls.append({"phase": "backward", "bytes": 3 * bhl + 2 * hl, "flops": 2 * conv})
    return {"model_flops": 3 * forward if train else forward,
            "convs": calls * cfg["n_layer"]}
