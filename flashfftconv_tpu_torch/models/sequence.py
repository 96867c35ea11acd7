"""Generic sequence-task harness (PyTorch): encoders, pools, decoders and
``SequenceModel``.

Port of the JAX package's ``models/sequence.py``: input encoders
(linear, embedding, one-hot, sinusoidal position, image patches), pools
between stages (average, linear, up-linear, spectral), output decoders
(last / first / mean / causal pool / sum / full, and the LRA-retrieval
dual-sequence head), and ``SequenceModel``, which composes encoder ->
stages of ``lm.Block`` mixers (pooled between stages) -> final LayerNorm
-> decoder from registry-style configs (``"name"`` or ``{"_name_": name,
...}``).

The semantics are the flax modules' vectorised ones: ``lengths`` masks a
padded suffix (no per-sample loop) and ``DownSpectralPool`` keeps the low
bands of an FFT along L (``torch.fft``, as the flax module uses
``jnp.fft``). A flax module sizes its parameters from the first input; here
the sizes come up front: ``d_input`` for the linear and patch encoders
(the patch encoder's input channels), ``in_features`` for pools and
decoders (``SequenceModel`` passes the width each stage has).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from flashfftconv_tpu_torch.models.layers import Dense, Embed, LayerNorm, normal, zeros
from flashfftconv_tpu_torch.models.lm import Block
from flashfftconv_tpu_torch.ops.plan import resolve_device

# --- encoders ---------------------------------------------------------------


class LinearEncoder(nn.Module):
    """Dense projection d_input -> d_model in the input's dtype."""

    def __init__(self, d_model, d_input, device="cuda", generator=None):
        super().__init__()
        self.proj = Dense(d_input, d_model, device=device, generator=generator)

    def forward(self, x):
        return self.proj(x, dtype=x.dtype)


class EmbeddingEncoder(nn.Module):
    """Token embedding, rows in ``dtype``."""

    def __init__(self, n_tokens, d_model, dtype=torch.float32, device="cuda", generator=None):
        super().__init__()
        self.embed = Embed(n_tokens, d_model, dtype=dtype, device=device, generator=generator)

    def forward(self, x):
        return self.embed(x)


class OneHotEncoder(nn.Module):
    """One-hot tokens straight into the model width (f32)."""

    def __init__(self, n_tokens, d_model):
        super().__init__()
        if n_tokens > d_model:
            raise ValueError("one-hot encoder needs n_tokens <= d_model")
        self.d_model = d_model

    def forward(self, x):
        return F.one_hot(x.long(), self.d_model).float()


class PositionalEncoder(nn.Module):
    """x + the sinusoidal position encoding (computed in f32), then dropout."""

    def __init__(self, d_model, max_len=16384, dropout=0.0):
        super().__init__()
        self.d_model = d_model
        self.drop = nn.Dropout(dropout)

    def forward(self, x):
        length = x.shape[-2]
        pos = torch.arange(length, dtype=torch.float32, device=x.device)[:, None]
        div = torch.exp(torch.arange(0, self.d_model, 2, dtype=torch.float32, device=x.device)
                        * (-math.log(10000.0) / self.d_model))
        pe = torch.zeros(length, self.d_model, device=x.device)
        pe[:, 0::2] = torch.sin(pos * div)
        pe[:, 1::2] = torch.cos(pos * div)
        return self.drop(x.float() + pe).to(x.dtype)


class PatchEncoder(nn.Module):
    """(B, H, W, C) images -> (B, H*W/p^2, d_model) by a stride-p conv over
    p x p patches. ``patch_kernel`` (p, p, C, d_model) and ``patch_bias``
    are the flax Conv's kernel and bias."""

    def __init__(self, d_model, d_input, patch_size=4, device="cuda", generator=None):
        super().__init__()
        device = resolve_device(device)
        self.p = patch_size
        fan_in = patch_size * patch_size * d_input
        self.patch_kernel = normal((patch_size, patch_size, d_input, d_model),
                                   1.0 / math.sqrt(fan_in), generator, device)
        self.patch_bias = zeros((d_model,), device)

    def forward(self, x):
        w = self.patch_kernel.permute(3, 2, 0, 1).to(x.dtype)  # (out, in, p, p)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, self.patch_bias.to(x.dtype), stride=self.p)
        return y.permute(0, 2, 3, 1).reshape(x.shape[0], -1, w.shape[0])


# --- pools between stages ---------------------------------------------------------


def _check_stride(length: int, stride: int) -> None:
    if length % stride:
        raise ValueError(f"L={length} not divisible by stride {stride}")


class DownAvgPool(nn.Module):
    """Non-overlapping mean over ``stride`` steps: (B, L, D) -> (B, L/s, D)."""

    def __init__(self, in_features=None, stride=2, device="cuda", generator=None):
        super().__init__()
        self.stride, self.out_features = stride, in_features

    def forward(self, x):
        b, length, d = x.shape
        _check_stride(length, self.stride)
        return x.reshape(b, length // self.stride, self.stride, d).mean(dim=2)


class DownLinearPool(nn.Module):
    """Fold ``stride`` steps into the features, project to expand * D."""

    def __init__(self, in_features, stride=2, expand=1, device="cuda", generator=None):
        super().__init__()
        self.stride, self.out_features = stride, expand * in_features
        self.proj = Dense(stride * in_features, expand * in_features, device=device,
                          generator=generator)

    def forward(self, x):
        b, length, d = x.shape
        _check_stride(length, self.stride)
        return self.proj(x.reshape(b, length // self.stride, self.stride * d), dtype=x.dtype)


class UpLinearPool(nn.Module):
    """Project to stride * D / shrink, then unfold into ``stride`` steps."""

    def __init__(self, in_features, stride=2, shrink=1, device="cuda", generator=None):
        super().__init__()
        if in_features % shrink:
            raise ValueError(f"D={in_features} not divisible by shrink {shrink}")
        self.stride, self.out_features = stride, in_features // shrink
        self.proj = Dense(in_features, stride * (in_features // shrink), device=device,
                          generator=generator)

    def forward(self, x):
        b, length, _ = x.shape
        return self.proj(x, dtype=x.dtype).reshape(b, length * self.stride, -1)


class DownSpectralPool(nn.Module):
    """Fourier low-pass downsample: FFT along L, keep the lowest L/stride
    bands (low and high halves), inverse FFT at the shorter length, rescaled
    by new_L / L."""

    def __init__(self, in_features=None, stride=2, device="cuda", generator=None):
        super().__init__()
        self.stride, self.out_features = stride, in_features

    def forward(self, x):
        length = x.shape[-2]
        _check_stride(length, self.stride)
        new_l = length // self.stride
        xf = torch.fft.fft(x.float(), dim=-2)
        kept = torch.cat([xf[..., : new_l - new_l // 2, :], xf[..., length - new_l // 2 :, :]],
                         dim=-2)
        y = torch.fft.ifft(kept, dim=-2).real
        return (y * (new_l / length)).to(x.dtype)


# --- decoders -----------------------------------------------------------------


class SequenceDecoder(nn.Module):
    """Restrict the sequence axis, then project to ``d_output`` in f32.

    mode: 'last' | 'first' | 'mean' | 'pool' (causal running mean) | 'sum'
    (causal running sum) | 'full'. ``l_output`` 0 squeezes the length axis
    (classification). ``lengths`` (B,) masks padded suffixes."""

    def __init__(self, in_features=None, d_output=None, l_output=0, mode="last", device="cuda",
                 generator=None):
        super().__init__()
        if mode not in ("last", "first", "mean", "pool", "sum", "full"):
            raise ValueError(f"unknown decoder mode {mode!r}")
        self.l_output, self.mode = l_output, mode
        self.proj = (None if d_output is None else
                     Dense(in_features, d_output, dtype=torch.float32, device=device,
                           generator=generator))

    def forward(self, x, lengths=None):
        b, length, d = x.shape
        lout = max(self.l_output, 1)
        squeeze = self.l_output == 0
        if lengths is not None:
            valid = torch.arange(length, device=x.device)[None, :] < lengths[:, None]
            x = torch.where(valid[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))
        if self.mode == "last":
            if lengths is not None:
                idx = (lengths[:, None] - lout + torch.arange(lout, device=x.device)[None, :])
                idx = idx.clamp(0, length - 1)
                y = torch.gather(x, 1, idx[..., None].expand(b, lout, d))
            else:
                y = x[:, length - lout :, :]
        elif self.mode == "first":
            y = x[:, :lout, :]
        elif self.mode == "mean":
            if lengths is not None:
                y = x.sum(dim=1, keepdim=True) / lengths[:, None, None].clamp(min=1).to(x.dtype)
            else:
                y = x.mean(dim=1, keepdim=True)
            y = y.expand(b, lout, d)
        elif self.mode in ("pool", "sum"):
            csum = torch.cumsum(x.float(), dim=1)
            if self.mode == "pool":
                csum = csum / torch.arange(1, length + 1, dtype=torch.float32,
                                           device=x.device)[None, :, None]
            y = csum[:, length - lout :, :].to(x.dtype)
        else:  # full
            y, squeeze = x, False
        if squeeze:
            y = y[:, 0, :]
        return y if self.proj is None else self.proj(y.float())


class RetrievalDecoder(nn.Module):
    """Dual-sequence head for LRA Retrieval: the batch stacks the two
    documents (2B, L, D); each is pooled to a feature u, v, and the classifier
    sees [u, v, u - v, u * v] through fc1 (ReLU) and fc2."""

    def __init__(self, in_features, n_classes, d_model=None, mode="mean", activation=F.relu,
                 device="cuda", generator=None):
        super().__init__()
        self.feature = SequenceDecoder(mode=mode)
        self.activation = activation
        hidden = d_model or in_features
        mk = dict(dtype=torch.float32, device=device, generator=generator)
        self.fc1 = Dense(4 * in_features, hidden, **mk)
        self.fc2 = Dense(hidden, n_classes, **mk)

    def forward(self, x, lengths=None):
        u, v = self.feature(x, lengths=lengths).float().chunk(2, dim=0)
        h = torch.cat([u, v, u - v, u * v], dim=-1)
        return self.fc2(self.activation(self.fc1(h)))


# --- SequenceModel ----------------------------------------------------------------

ENCODERS = {"linear": LinearEncoder, "embedding": EmbeddingEncoder, "one-hot": OneHotEncoder,
            "position": PositionalEncoder, "patch2d": PatchEncoder}
POOLS = {"avg": DownAvgPool, "linear": DownLinearPool, "up-linear": UpLinearPool,
         "spectral": DownSpectralPool}
DECODERS = {"sequence": SequenceDecoder, "retrieval": RetrievalDecoder}


def _config(cfg) -> dict:
    return dict({"_name_": cfg} if isinstance(cfg, str) else cfg)


class SequenceModel(nn.Module):
    """Config-composed sequence model over (B, L, ...) inputs: the encoder
    list, ``n_stages`` stages of n_layers / n_stages ``lm.Block``s (pooled by
    ``pool`` between stages; a pool's stride divides the mixers' l_max
    after it), the final LayerNorm in f32 and the decoder. ``layer`` is a
    mixer name or a dict with ``mixer`` (or ``_name_``) and the mixer's
    options (under ``mixer_kwargs`` or inline). ``d_input`` is the input's
    feature count for a linear or patch encoder (its channels)."""

    def __init__(self, d_model, n_layers=2, layer="hyena", encoder="linear", decoder="sequence",
                 pool=None, n_stages=1, d_inner=None, dropout=0.0, l_max=None, n_tokens=None,
                 dtype=torch.float32, d_input=None, device="cuda", generator=None):
        super().__init__()
        device = resolve_device(device)
        mk = dict(device=device, generator=generator)
        self.dtype = dtype
        self.encoder = nn.ModuleList()
        for enc in encoder if isinstance(encoder, (list, tuple)) else [encoder]:
            cfg = _config(enc)
            name = cfg.pop("_name_")
            if name in ("embedding", "one-hot") and n_tokens is not None:
                cfg["n_tokens"] = n_tokens
            if name in ("linear", "patch2d"):
                cfg.setdefault("d_input", d_input)
            if name in ("linear", "embedding", "patch2d"):
                cfg.update(mk)
            self.encoder.append(ENCODERS[name](d_model=d_model, **cfg))

        layer = dict({"mixer": layer} if isinstance(layer, str) else layer)
        default = layer.pop("_name_", "hyena")
        mixer = layer.pop("mixer", default)
        mixer_kwargs = dict(layer.pop("mixer_kwargs", layer))
        if l_max is not None:
            mixer_kwargs = {"l_max": l_max, **mixer_kwargs}

        n_stages = max(n_stages, 1)
        per_stage = max(n_layers // n_stages, 1)
        self.blocks, self.pool = nn.ModuleList(), nn.ModuleList()
        d = d_model
        for stage in range(n_stages):
            for _ in range(per_stage):
                self.blocks.append(Block(d, d_inner or 4 * d, mixer=mixer,
                                         mixer_kwargs=mixer_kwargs, resid_dropout=dropout, **mk))
            if pool is not None and stage < n_stages - 1:
                cfg = _config(pool)
                p = POOLS[cfg.pop("_name_")](in_features=d, **cfg, **mk)
                self.pool.append(p)
                d = p.out_features
                if l_max is not None and "l_max" in mixer_kwargs:
                    mixer_kwargs = {**mixer_kwargs,
                                    "l_max": mixer_kwargs["l_max"] // cfg.get("stride", 2)}
        self.per_stage = per_stage
        self.ln_f = LayerNorm(d, device=device)
        cfg = _config(decoder)
        self.decoder = DECODERS[cfg.pop("_name_")](in_features=d, **cfg, **mk)

    def forward(self, x, lengths=None):
        for enc in self.encoder:
            x = enc(x)
        x = x.to(self.dtype)
        for i, block in enumerate(self.blocks):
            x = block(x)
            stage = i // self.per_stage
            if (i + 1) % self.per_stage == 0 and stage < len(self.pool):
                x = self.pool[stage](x)
        return self.decoder(self.ln_f(x.float()).to(self.dtype), lengths=lengths)
