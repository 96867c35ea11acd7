#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (flashfftconv_tpu_torch) on one GPU.

Run from the root of a checkout on a machine with an H100:

    python3 chip_smoke.py [--seed 0] [--out-dir DIR]
                          [--phases build,identity,kernels,serve,train,parity,grad_parity,
                                    dna,dna_train,long_parity,bert,bert_train,bert_parity,
                                    timing[,profile]]

Phases, each of which fails the run by raising:
  build     builds every CUDA kernel from csrc/ with nvcc (one nvcc per
            source, started together) and prints ptxas's register report;
  identity  prints the card's name and power limit;
  kernels   holds each kernel, forward and backward, against its plain
            PyTorch version on the card, at the main paths' shapes and at
            gated, padded, odd-batch and ragged-channel shapes, with the
            tolerance printed;
  serve     builds Hyena-125M (12 layers, d_model 768, l_max 8192, vocab
            50257, bf16, random weights from --seed) and answers 4 requests
            (prompts of 512..4096 tokens, 8 new tokens each, greedy) through
            utils.generation.generate, after one scoring forward; checks the
            logits are finite and that every kernel launched 12 times a forward;
  train     trains the same model (B=4, L=8192, bf16 activations, f32 master
            weights, dropout on, torch seeded from --seed) on the byte ids of
            the repo's Python sources: 2 warm-up and 5 timed steps of the
            examples/lm recipe (AdamW lr 3e-4 with 2 warm-up steps, weight
            decay 0.1, clip 1.0); checks finite, falling loss and each
            kernel's launches a step; prints step time, tokens/s and peak memory;
  parity    a 2-layer, d_model 128, l_max 1024 Hyena LM in f32 with the same
            weights on the card (kernels) and on the CPU (plain versions):
            logits agree within 2e-3;
  grad_parity  the same LM's grads on the card (backward kernels) and on the
            CPU (plain backward) agree within 1e-3 of each parameter's
            largest |grad|, and so do the losses after one AdamW step (1e-4);
  dna       builds HyenaDNA large-1m (8 layers, d_model 256, d_inner 1024,
            l_max 1,048,576, FFT size 2,097,152, bf16, random weights from
            --seed) and answers 4 scoring requests of 131,072 to 1,048,576
            bases of the synthetic genome through models.dna.score, then 1
            warm-up and 3 timed forwards at 1,048,576 bases; checks finite
            logits and the exact launches a forward (8 long_spectrum, 8
            long_conv, 24 butterfly, 8 depthwise, no one-block conv); prints
            bits per base, forward time, tokens/ms and peak memory;
  dna_train  trains the same HyenaDNA large-1m (B=1, 1,048,576 bases, bf16
            activations, f32 master weights, no dropout, the levers of
            models.dna.train_config) on windows of the synthetic genome from
            utils.data.lm_batches: 1 warm-up and 3 timed steps of the
            examples/hyena_dna recipe (clip 1.0, AdamW lr 6e-4, weight decay
            0.1, no schedule); checks finite, falling loss and the exact
            launches a step; prints step time, tokens/s and peak memory;
  long_parity  a 2-layer, d_model 64, l_max 65536 HyenaDNA in f32 (FFT size
            131072) with the same weights on the card (long kernels) and on
            the CPU (plain versions): logits agree within 2e-3, grads within
            1e-3 of each parameter's largest |grad|, and a second backward on
            the card gives the same grads bit for bit (but the embedding
            table's, which PyTorch adds up with atomics); then a 2-layer,
            d_model 256, l_max 131072 f32 HyenaDNA on the card with every
            memory lever on against the same weights with none: loss and
            grads agree within 1e-4;
  bert      builds M2-BERT base-110M (12 layers, d_model 768, l_max 128,
            vocab 30522, dense MLP, tied MLM head, bf16, random weights from
            --seed; every long conv at FFT size 256 on the direct kernels)
            and answers 4 fill-mask requests of (B, L) = (1, 128), (8, 100),
            (32, 128) and (128, 128) over the byte ids of the repo's Python
            sources with 15% of positions masked, through models.bert.fill_mask,
            then 1 warm-up and 5 timed forwards at B=128, L=128; checks finite
            logits and the exact launches a forward (24 direct_conv, 24
            spectrum, 12 depthwise, no monarch_conv); prints forward time,
            tokens/ms, seqs/s and peak memory;
  bert_train  trains the same model (B=128, L=128, bf16 activations, f32
            master weights, dropout 0.1) on utils.data.mlm_batches of the same
            bytes: 2 warm-up and 5 timed steps of the examples/bert recipe
            (clip 1.0, AdamW lr 8e-4, weight decay 1e-5 on every parameter,
            the MLM loss over the masked positions); checks finite, falling
            loss and the exact launches a step; prints step time, tokens/s
            and peak memory;
  bert_parity  a 2-layer, d_model 128, l_max 128 f32 M2BertForMaskedLM with
            the same weights on the card (direct kernels) and on the CPU
            (plain versions): logits within 2e-3, masked-LM grads within 1e-3
            of each parameter's largest |grad|, and a second backward on the
            card gives the same grads bit for bit (but the embedding tables');
  timing    times each kernel, its plain version and a PyTorch yardstick
            with CUDA events at the main paths' shapes, and the Monarch conv
            beside the direct one at FFT sizes 256 and 512;
  profile   (only when named in --phases) traces one Hyena-125M forward
            and one train step with torch.profiler: device time by kernel
            and by kind, and the device's busy share of the wall time; then
            one HyenaDNA forward and one HyenaDNA train step, then one
            M2-BERT forward and one M2-BERT train step.

Prints one JSON line of kernels (launches counted in the train phase, those
of the three long forward kernels in the dna phase, those of the two long
backward kernels in the dna_train phase, those of the direct kernels in the
bert_train phase), the
card's name and power limit (nvidia-smi), then, as the last line,
{"ok": true, "device": {...}}. Exits non-zero
with no result when there is no CUDA device or no package beside this file.
With --out-dir DIR a copy of all numbers goes to DIR/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
PHASES = ("build", "identity", "kernels", "serve", "train", "parity", "grad_parity", "dna",
          "dna_train", "long_parity", "bert", "bert_train", "bert_parity", "timing")
OPT_IN_PHASES = ("profile",)

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and f32 (non-tensor) FLOP/s.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

# Hyena-125M serving shapes (examples/lm/train.py preset): one forward runs
# each kernel once per layer.
B, D_MODEL, N_LAYER, L_MAX, VOCAB = 4, 768, 12, 8192, 50257
N_FFT = 2 * L_MAX
PROMPTS = (512, 1024, 2048, 4096)
NEW_TOKENS = 8
TRAIN_WARMUP, TRAIN_TIMED = 2, 5

# HyenaDNA large-1m serving shapes (models/dna.py preset): one forward runs
# one long conv a layer at FFT size 2 * l_max, whatever the request's length.
DNA_MODEL = "large-1m"
DNA_D_MODEL, DNA_N_LAYER, DNA_L_MAX = 256, 8, 1_048_576
DNA_N_FFT = 2 * DNA_L_MAX
DNA_REQUESTS = (131_072, 262_144, 524_288, 1_048_576)
DNA_WARMUP, DNA_TIMED = 1, 3
DNA_TRAIN_WARMUP, DNA_TRAIN_TIMED = 1, 3
LONG_SIZES = (65536, 131072, 524288, 2097152, 4194304)

# M2-BERT base-110M (examples/bert/train.py preset): every layer runs two
# long convs (the gated conv and the residual one) at FFT size 2 * l_max.
BERT_MODEL = "base-110M"
BERT_B, BERT_L, BERT_D_MODEL, BERT_N_LAYER = 128, 128, 768, 12
BERT_N_FFT = 2 * BERT_L
BERT_REQUESTS = ((1, 128), (8, 100), (32, 128), (128, 128))
BERT_WARMUP, BERT_TIMED = 1, 5
BERT_TRAIN_WARMUP, BERT_TRAIN_TIMED = 2, 5
DIRECT_SIZES = (16, 32, 64, 128, 256, 512)

KERNELS = {
    "spectrum": dict(
        source="flashfftconv_tpu_torch/csrc/spectrum.cu",
        replaces="flashfftconv_tpu/ops/monarch_pallas.py:558",
    ),
    "monarch_conv": dict(
        source="flashfftconv_tpu_torch/csrc/monarch_conv.cu",
        replaces="flashfftconv_tpu/ops/monarch_pallas.py:340",
    ),
    "depthwise": dict(
        source="flashfftconv_tpu_torch/csrc/depthwise.cu",
        replaces="flashfftconv_tpu/ops/depthwise.py:143",
    ),
    "monarch_conv_bwd": dict(
        source="flashfftconv_tpu_torch/csrc/monarch_conv_bwd.cu",
        replaces="flashfftconv_tpu/ops/monarch_pallas.py:1281",
    ),
    # dk_finish is the card's counterpart of _finish_dk, an XLA Monarch IDFT
    # (not a Pallas kernel) that finishes _bwd_fused_io_tiles's dk.
    "dk_finish": dict(
        source="flashfftconv_tpu_torch/csrc/monarch_conv_bwd.cu",
        replaces="flashfftconv_tpu/ops/monarch_pallas.py:2953",
    ),
    "depthwise_bwd": dict(
        source="flashfftconv_tpu_torch/csrc/depthwise_bwd.cu",
        replaces="flashfftconv_tpu/ops/depthwise.py:360",
    ),
    "butterfly": dict(
        source="flashfftconv_tpu_torch/csrc/butterfly.cu",
        replaces="flashfftconv_tpu/ops/monarch_pallas.py:2074",
    ),
    # the band kernel of the long conv, counted on its wrapper long_conv_inner
    "long_conv": dict(
        source="flashfftconv_tpu_torch/csrc/long_conv.cu",
        replaces="flashfftconv_tpu/ops/monarch_pallas.py:1928",
    ),
    "long_spectrum": dict(
        source="flashfftconv_tpu_torch/csrc/long_spectrum.cu",
        replaces="flashfftconv_tpu/ops/monarch_pallas.py:616",
    ),
    # the band kernel of the long backward, counted on its wrapper
    # long_conv_bwd_inner
    "long_conv_bwd": dict(
        source="flashfftconv_tpu_torch/csrc/long_conv_bwd.cu",
        replaces="flashfftconv_tpu/ops/monarch_pallas.py:2843",
    ),
    "long_dk_finish": dict(
        source="flashfftconv_tpu_torch/csrc/long_conv_bwd.cu",
        replaces="flashfftconv_tpu/ops/monarch_pallas.py:740",
    ),
    "direct_conv": dict(
        source="flashfftconv_tpu_torch/csrc/direct_conv.cu",
        replaces="flashfftconv_tpu/ops/monarch_pallas.py:477",
    ),
    "direct_conv_bwd": dict(
        source="flashfftconv_tpu_torch/csrc/direct_conv.cu",
        replaces="flashfftconv_tpu/ops/monarch_pallas.py:1460",
    ),
}
# The phase whose run gives a kernel's launches in the JSON line.
LAUNCH_PHASE = {"butterfly": "dna", "long_conv": "dna", "long_spectrum": "dna",
                "long_conv_bwd": "dna_train", "long_dk_finish": "dna_train",
                "direct_conv": "bert_train", "direct_conv_bwd": "bert_train"}
# The phases whose results the kernels JSON line reads.
JSON_PHASES = {"kernels", "train", "dna", "dna_train", "bert_train", "timing"}
# Launches of each kernel in one Hyena-125M train step: the backward
# recomputes every long conv's kernel spectrum.
TRAIN_LAUNCHES = {"spectrum": 2 * N_LAYER, "monarch_conv": N_LAYER, "monarch_conv_bwd": N_LAYER,
                  "dk_finish": N_LAYER, "depthwise": N_LAYER, "depthwise_bwd": N_LAYER}
# Launches in one HyenaDNA forward: a layer runs long_spectrum (one forward
# butterfly and its band kernel), long_conv (butterfly, band kernel, inverse
# butterfly) and the short depthwise conv; the one-block kernels never run.
DNA_LAUNCHES = {"long_spectrum": DNA_N_LAYER, "long_conv": DNA_N_LAYER,
                "butterfly": 3 * DNA_N_LAYER, "depthwise": DNA_N_LAYER, "spectrum": 0,
                "monarch_conv": 0}
# Launches in one HyenaDNA train step with every block rematerialised. A
# layer's forward and its replay in the backward each run long_spectrum (1
# butterfly), long_conv (2 butterflies) and the short conv; its backward runs
# long_spectrum again (1 butterfly), the butterflies of u and dout, the band
# backward, the inverse butterfly of du, long_dk_finish (1 inverse butterfly)
# and the short conv's backward.
DNA_TRAIN_LAUNCHES = {"long_spectrum": 3 * DNA_N_LAYER, "long_conv": 2 * DNA_N_LAYER,
                      "long_conv_bwd": DNA_N_LAYER, "long_dk_finish": DNA_N_LAYER,
                      "butterfly": 11 * DNA_N_LAYER, "depthwise": 2 * DNA_N_LAYER,
                      "depthwise_bwd": DNA_N_LAYER, "spectrum": 0, "monarch_conv": 0,
                      "monarch_conv_bwd": 0, "dk_finish": 0}
# Launches in one M2-BERT forward: a layer runs the short conv once and two
# long convs, each its kernel's spectrum and one direct_conv.
BERT_LAUNCHES = {"direct_conv": 2 * BERT_N_LAYER, "spectrum": 2 * BERT_N_LAYER,
                 "depthwise": BERT_N_LAYER, "monarch_conv": 0}
# ... and in one train step: the backward recomputes each spectrum and runs
# direct_conv_bwd and dk_finish a conv, and the short conv's backward.
BERT_TRAIN_LAUNCHES = {"direct_conv": 2 * BERT_N_LAYER, "direct_conv_bwd": 2 * BERT_N_LAYER,
                       "spectrum": 4 * BERT_N_LAYER, "dk_finish": 2 * BERT_N_LAYER,
                       "depthwise": BERT_N_LAYER, "depthwise_bwd": BERT_N_LAYER,
                       "monarch_conv": 0, "monarch_conv_bwd": 0}


def log(msg: str) -> None:
    print(msg, flush=True)


def f32_tol(ref) -> float:
    """f32 FFT roundoff grows like log2(N) * 6e-8 (1e-6 at N = 32768) of the
    output's scale; 2e-5 of the largest |output| leaves a 20x margin."""
    return 2e-5 * float(ref.abs().max()) + 1e-7


def lowp_tol(ref) -> float:
    """Kernel and plain round the same f32 result to bf16: they may differ by
    one bf16 ulp, at most 2^-7 of the largest |output|."""
    return 2.0**-7 * float(ref.abs().max()) + 1e-6


def sum_tol(abs_sum) -> float:
    """An f32 sum of many products, added in another order: its rounding is
    below 1e-5 of the sum of the terms' magnitudes (chains of < 100
    additions at 6e-8 each)."""
    return 1e-5 * float(abs_sum.abs().max()) + 1e-7


def compare(name, got, ref, tol) -> float:
    err = float((got.float() - ref.float()).abs().max())
    ok = math.isfinite(err) and err <= tol
    log(f"  {name}: max_abs_err={err:.3e} tol={tol:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version ({err} > {tol})")
    return err


def phase_build():
    from flashfftconv_tpu_torch.ops import _build

    t0 = time.perf_counter()
    paths = _build.build_all()
    log(f"built {len(paths)} kernel libraries in {time.perf_counter() - t0:.1f} s")
    for name in paths:
        for line in _build.build_log(name).splitlines():
            m = re.search(r"Compiling entry function '(\w+)'|(Used \d+ registers.*)", line)
            if m:
                log(f"  {name}: {m.group(1) or m.group(2)}")
    return {"build_s": time.perf_counter() - t0}


def phase_identity(torch):
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"device: {name} (count {torch.cuda.device_count()})")
    return {"device": name, "nvidia_smi": smi}


def _kernel_inputs(torch, g, dev):
    """Main-path-shaped inputs: filter taps with a slow decay, unit activations
    scaled by 0.02 as in the JAX package's tests."""
    t = torch.arange(L_MAX, dtype=torch.float32)
    k = torch.randn(D_MODEL, L_MAX, generator=g) * 0.02 * torch.exp(-t / 1000)
    u = (torch.randn(B, D_MODEL, L_MAX, generator=g) * 0.02).to(torch.bfloat16)
    x = torch.randn(B, 3 * D_MODEL, L_MAX, generator=g).to(torch.bfloat16)
    w = torch.rand(3 * D_MODEL, 3, generator=g) * 2 / math.sqrt(3 * D_MODEL)
    bias = torch.randn(3 * D_MODEL, generator=g) * 0.1
    return [a.to(dev) for a in (k, u, x, w, bias)]


def phase_kernels(torch, g):
    from flashfftconv_tpu_torch.ops import monarch, monarch_cuda
    from flashfftconv_tpu_torch.ops import depthwise as dw
    from flashfftconv_tpu_torch.ops.plan import make_plan

    dev = torch.device("cuda")
    errs = {}
    plan = make_plan(N_FFT, torch.bfloat16, device=dev)
    k, u, x, w, bias = _kernel_inputs(torch, g, dev)

    log(f"spectrum: H={D_MODEL} k_len={L_MAX} N={N_FFT} factors={plan.factors}")
    k_f = monarch_cuda.spectrum(plan, k)
    ref = monarch.kernel_spectrum(plan, k)
    errs["spectrum"] = compare("spectrum", torch.view_as_real(k_f), torch.view_as_real(ref),
                               f32_tol(torch.view_as_real(ref)))
    torch.cuda.synchronize()

    log(f"monarch_conv: B={B} H={D_MODEL} L={L_MAX} N={N_FFT} bf16 ungated")
    y = monarch_cuda.monarch_conv(plan, u, k_f)
    ref = monarch.conv_with_spectrum(plan, u, k_f)
    errs["monarch_conv"] = compare("monarch_conv", y, ref, lowp_tol(ref))
    torch.cuda.synchronize()

    for n in (256, 1024, 4096, 32768):
        p = make_plan(n, torch.float32, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            b, h, length = 3, 7, n // 2 + 3
            kk = torch.randn(h, n // 2 - 1, generator=g).to(dev) * 0.1
            uu, pre, post = (torch.randn(b, h, length, generator=g).to(dev, dtype) for _ in "abc")
            kf = monarch_cuda.spectrum(p, kk)
            compare(f"spectrum N={n}", torch.view_as_real(kf),
                    torch.view_as_real(monarch.kernel_spectrum(p, kk)),
                    f32_tol(torch.view_as_real(kf)))
            yy = monarch_cuda.monarch_conv(p, uu, kf, pre, post)
            rr = monarch.conv_with_spectrum(p, uu, kf, pre, post)
            tol = f32_tol(rr) if dtype == torch.float32 else lowp_tol(rr)
            compare(f"monarch_conv gated N={n} B={b} H={h} L={length} {dtype}", yy, rr, tol)
        torch.cuda.synchronize()

    log(f"depthwise: B={B} D={3 * D_MODEL} L={L_MAX} K=3 padding=(2, 0) bias bf16 BHL")
    y = dw.depthwise(x, w, bias, (2, 0), True)
    ref = dw.depthwise_plain(x, w, bias, (2, 0), True)
    errs["depthwise"] = compare("depthwise", y, ref, lowp_tol(ref))
    xb = torch.randn(2, 1000, 300, generator=g).to(dev)
    wb = torch.randn(5, 300, generator=g).to(dev) * 0.3
    bb = torch.randn(300, generator=g).to(dev)
    ref = dw.depthwise_plain(xb, wb, bb, (3, 1), False)
    compare("depthwise BLH B=2 L=1000 D=300 K=5 padding=(3, 1) f32",
            dw.depthwise(xb, wb, bb, (3, 1), False), ref, f32_tol(ref))
    torch.cuda.synchronize()

    log(f"monarch_conv_bwd + dk_finish: B={B} H={D_MODEL} L={L_MAX} N={N_FFT} bf16 ungated")
    dout = (torch.randn(B, D_MODEL, L_MAX, generator=g) * 0.02).to(dev, torch.bfloat16)
    errs["monarch_conv_bwd"], errs["dk_finish"] = _check_conv_bwd(
        torch, plan, "main path", u, k_f, None, None, dout, L_MAX)
    for n in (256, 1024, 4096, 32768):
        p = make_plan(n, torch.float32, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            for b, h, length, gated in ((3, 7, n // 2 + 3, True), (2, 5, n, False)):
                k_len = n // 2 - 1
                kf = monarch_cuda.spectrum(p, torch.randn(h, k_len, generator=g).to(dev) * 0.1)
                uu, pre, post, dd = (torch.randn(b, h, length, generator=g).to(dev, dtype)
                                     for _ in "abcd")
                gates = (pre, post) if gated else (None, None)
                what = (f"{'gated' if gated else 'ungated'} N={n} B={b} H={h} L={length} "
                        f"k_len={k_len} {dtype}")
                _check_conv_bwd(torch, p, what, uu, kf, *gates, dd, k_len)
        torch.cuda.synchronize()

    log(f"depthwise_bwd: B={B} D={3 * D_MODEL} L={L_MAX} K=3 padding=(2, 0) bf16 BHL")
    dy = torch.randn(x.shape, generator=g).to(dev, torch.bfloat16)
    errs["depthwise_bwd"] = _check_dw_bwd(torch, "main path", x, w, dy, (2, 0), True)
    for (b, d, length), k, pad, is_bhl, dtype in (
        ((2, 300, 1000), 5, (3, 1), False, torch.float32),
        ((2, 300, 1000), 5, (3, 1), False, torch.bfloat16),
        ((3, 37, 1031), 5, (1, 3), True, torch.float16),
        ((3, 37, 1031), 7, (0, 9), False, torch.float32),
        ((2, 64, 2048), 3, (2, 0), True, torch.float32),
    ):
        xs = (b, d, length) if is_bhl else (b, length, d)
        xx = torch.randn(xs, generator=g).to(dev, dtype)
        ww = (torch.randn((d, k) if is_bhl else (k, d), generator=g) * 0.3).to(dev)
        out_len = length + sum(pad) - k + 1
        dd = torch.randn((b, d, out_len) if is_bhl else (b, out_len, d), generator=g).to(dev, dtype)
        _check_dw_bwd(torch, f"{'BHL' if is_bhl else 'BLH'} B={b} D={d} L={length} K={k} "
                      f"padding={pad} {dtype}", xx, ww, dd, pad, is_bhl)
    torch.cuda.synchronize()
    errs.update(_check_direct_kernels(torch, g))
    errs.update(_check_long_kernels(torch, g))
    _check_operator_spread(torch)
    return errs


def _check_operator_spread(torch, runs=12):
    """A small f32 Hyena operator (d_model 64, l_max 512, B=3, L=500) built
    `runs` times from one seed on the card and on the CPU: the spread of the
    card's largest error. Tolerance: 2e-5 of the largest |output| for the
    kernels, plus 16 ulps of the largest in-projection value for the order in
    which cuBLAS adds up the f32 matmuls (the output is 50 times smaller
    than that intermediate)."""
    from flashfftconv_tpu_torch.models.hyena import HyenaOperator

    u = torch.randn(3, 500, 64, generator=torch.Generator().manual_seed(1))
    errs = []
    for _ in range(runs):
        ops = {dev: HyenaOperator(64, 512, conv_dtype=torch.float32, device=dev,
                                  generator=torch.Generator().manual_seed(0))
               for dev in ("cpu", "cuda")}
        with torch.inference_mode():
            ref = ops["cpu"](u)
            errs.append(float((ops["cuda"](u.cuda()).cpu() - ref).abs().max()))
            x_max = float(torch.matmul(ops["cpu"].in_proj, u.transpose(1, 2)).abs().max())
    tol = f32_tol(ref) + 16 * 2.0**-23 * x_max
    log(f"hyena operator, card vs CPU, {runs} runs: max_abs_err min {min(errs):.3e} max "
        f"{max(errs):.3e}, tol={tol:.3e}, |out| <= {float(ref.abs().max()):.3e}, "
        f"|in-projection| <= {x_max:.3e}")
    if not max(errs) <= tol:
        raise AssertionError(f"the operator on the card disagrees with the CPU: {errs}")


def _long_inputs(torch, g, dev):
    """Main-path-shaped inputs of the long kernels, made on the card: the
    taps of one layer and one request of l_max bases' worth of activations."""
    gd = torch.Generator(device=dev).manual_seed(g.initial_seed())
    t = torch.arange(DNA_L_MAX, dtype=torch.float32, device=dev)
    k = torch.randn(DNA_D_MODEL, DNA_L_MAX, generator=gd, device=dev) * 0.02 * torch.exp(-t / 1000)
    u = (torch.randn(1, DNA_D_MODEL, DNA_L_MAX, generator=gd, device=dev) * 0.02).to(torch.bfloat16)
    return k, u


def _check_long(torch, plan, what, u, k, pre=None, post=None):
    """butterfly (both directions), long_conv_inner and long_spectrum against
    their plain versions on the same inputs, and the chain long_conv against
    the torch.fft oracle. Returns {kernel: max abs err}."""
    from flashfftconv_tpu_torch.ops import monarch, monarch_cuda

    real = torch.view_as_real
    low = u.dtype != torch.float32
    length = u.shape[-1]
    k_f = monarch_cuda.long_spectrum(plan, k)
    ref = real(monarch.long_spectrum_plain(plan, k))
    errs = {"long_spectrum": compare(f"long_spectrum {what}", real(k_f), ref, f32_tol(ref))}
    del ref
    zr = monarch.butterfly_plain(plan, u, pre)
    z = monarch_cuda.butterfly(plan, u, pre)
    fwd = compare(f"butterfly forward {what}", real(z), real(zr), f32_tol(real(zr)))
    del z
    z2r = monarch.long_conv_inner_plain(plan, zr, k_f)
    z2 = monarch_cuda.long_conv_inner(plan, zr, k_f)
    errs["long_conv"] = compare(f"long_conv_inner {what}", real(z2), real(z2r), f32_tol(real(z2r)))
    del z2, zr
    yr = monarch.butterfly_inverse_plain(plan, z2r, length, post, u.dtype)
    y = monarch_cuda.butterfly(plan, z2r, post, inverse=True, length=length, dtype=u.dtype)
    inv = compare(f"butterfly inverse {what}", y, yr, lowp_tol(yr) if low else f32_tol(yr))
    errs["butterfly"] = max(fwd, inv)
    del y, yr, z2r
    ref = monarch.fft_conv_reference(plan.seqlen, u, k, pre, post)
    compare(f"long_conv vs torch.fft {what}", monarch_cuda.long_conv(plan, u, k_f, pre, post),
            ref, lowp_tol(ref) if low else f32_tol(ref))
    torch.cuda.synchronize()
    return errs


def _check_long_bwd(torch, plan, what, u, k, pre, post, g):
    """long_conv_bwd_inner and long_dk_finish against their plain versions on
    the same bands and partials, the whole long backward (long_conv_bwd, then
    long_dk_finish) against conv_bwd_plain and dk_finish_plain, and a second
    run of the whole backward against the first, bit for bit. Returns
    {kernel: max abs err}."""
    from flashfftconv_tpu_torch.ops import monarch, monarch_cuda

    real = torch.view_as_real
    low = u.dtype != torch.float32
    gated = pre is not None
    dout = torch.randn(u.shape, generator=g).to(u.device, u.dtype)
    k_len = k.shape[-1]
    k_f = monarch_cuda.long_spectrum(plan, k)
    zu = monarch.butterfly_plain(plan, u, pre)
    zg = monarch.butterfly_plain(plan, dout.float() * post.float() if gated else dout)
    got = monarch_cuda.long_conv_bwd_inner(plan, zu, zg, k_f, need_y=gated)
    ref = monarch.long_conv_bwd_inner_plain(plan, zu, zg, k_f, need_y=gated)
    del zu, zg
    err = 0.0
    for name, a, r in zip(("du bands", "y bands", "partials"), got, ref):
        if r is not None:
            err = max(err, compare(f"long_conv_bwd_inner {what}: {name}", real(a), real(r),
                                   f32_tol(real(r))))
    partials = ref[2]
    del got, ref
    dk_ref = monarch.long_dk_finish_plain(plan, partials, k_len)
    errs = {"long_conv_bwd": err,
            "long_dk_finish": compare(f"long_dk_finish {what}: dk",
                                      monarch_cuda.long_dk_finish(plan, partials, k_len), dk_ref,
                                      f32_tol(dk_ref))}
    del partials, dk_ref

    def whole():
        du, dpre, dpost, parts = monarch_cuda.long_conv_bwd(plan, u, k_f, pre, post, dout)
        return du, dpre, dpost, monarch_cuda.long_dk_finish(plan, parts, k_len)

    first = whole()
    ref = monarch.conv_bwd_plain(plan, u, k_f, pre, post, dout)
    ref = (*ref[:3], monarch.dk_finish_plain(plan, ref[3], k_len))
    for name, a, r in zip(("du", "dpre", "dpost", "dk"), first, ref):
        if r is not None:
            f32 = name == "dk" or not low
            compare(f"long backward vs conv_bwd_plain {what}: {name}", a, r,
                    f32_tol(r) if f32 else lowp_tol(r))
    del ref
    for name, a, r in zip(("du", "dpre", "dpost", "dk"), first, whole()):
        if a is not None and not torch.equal(a, r):
            raise AssertionError(f"long backward {what}: two runs differ in {name}")
    torch.cuda.synchronize()
    return errs


def _check_long_kernels(torch, g):
    """The long kernels, forward and backward, at the dna path's shapes, then
    at every listed FFT size in f32 and bf16: B = 1 ungated at L = N/2, B = 3
    and 4 gated at ragged lengths and channel counts; and the short depthwise
    conv at 1,048,576 positions."""
    from flashfftconv_tpu_torch.ops import depthwise as dw
    from flashfftconv_tpu_torch.ops.plan import make_plan

    dev = torch.device("cuda")
    plan = make_plan(DNA_N_FFT, torch.bfloat16, device=dev)
    k, u = _long_inputs(torch, g, dev)
    log(f"long kernels: B=1 H={DNA_D_MODEL} L={DNA_L_MAX} N={DNA_N_FFT} bf16 ungated, "
        f"factors={plan.factors} (outer {plan.outer}, band {plan.band})")
    errs = _check_long(torch, plan, "main path", u, k)
    errs.update(_check_long_bwd(torch, plan, "main path", u, k, None, None, g))
    del k, u, plan
    for n in LONG_SIZES:
        p = make_plan(n, torch.float32, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            for b, h, length, gated in ((1, 3, n // 2, False), (3, 2, n // 2 + 3, True),
                                        (4, 2, n - 5, True)):
                uu, pre, post = (torch.randn(b, h, length, generator=g).to(dev, dtype)
                                 for _ in "abc")
                kk = (torch.randn(h, n // 2 - 1, generator=g) * 0.05).to(dev)
                gates = (pre, post) if gated else (None, None)
                what = (f"N={n} B={b} H={h} L={length} {'gated' if gated else 'ungated'} "
                        f"{dtype}")
                _check_long(torch, p, what, uu, kk, *gates)
                _check_long_bwd(torch, p, what, uu, kk, *gates, g)
        del p
    d = 3 * DNA_D_MODEL
    log(f"depthwise: B=1 D={d} L={DNA_L_MAX} K=3 padding=(2, 0) bias bf16 BHL")
    x = torch.randn(1, d, DNA_L_MAX, generator=g).to(dev, torch.bfloat16)
    w = (torch.rand(d, 3, generator=g) * 2 / math.sqrt(d)).to(dev)
    bias = (torch.randn(d, generator=g) * 0.1).to(dev)
    ref = dw.depthwise_plain(x, w, bias, (2, 0), True)
    compare("depthwise at the dna path's shape", dw.depthwise(x, w, bias, (2, 0), True), ref,
            lowp_tol(ref))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return errs


def _check_direct(torch, plan, what, u, k, pre, post, dout):
    """spectrum, direct_conv, direct_conv_bwd and dk_finish against their
    plain versions on the same inputs, and a second backward against the
    first, bit for bit. Returns (direct_conv error, direct_conv_bwd error)."""
    from flashfftconv_tpu_torch.ops import monarch, monarch_cuda

    real = torch.view_as_real
    low = u.dtype != torch.float32
    k_len = k.shape[-1]
    k_f = monarch_cuda.spectrum(plan, k)
    ref = real(monarch.kernel_spectrum(plan, k))
    compare(f"spectrum {what}", real(k_f), ref, f32_tol(ref))
    ref = monarch.direct_conv_plain(plan, u, k_f, pre, post)
    fwd = compare(f"direct_conv {what}", monarch_cuda.direct_conv(plan, u, k_f, pre, post), ref,
                  lowp_tol(ref) if low else f32_tol(ref))
    got = monarch_cuda.direct_conv_bwd(plan, u, k_f, pre, post, dout)
    ref = monarch.direct_conv_bwd_plain(plan, u, k_f, pre, post, dout)
    bwd = 0.0
    for name, a, r in zip(("du", "dpre", "dpost"), got[:3], ref[:3]):
        if r is not None:
            bwd = max(bwd, compare(f"direct_conv_bwd {what}: {name}", a, r,
                                   lowp_tol(r) if low else f32_tol(r)))
    pr = real(ref[3])
    bwd = max(bwd, compare(f"direct_conv_bwd {what}: dk spectrum", real(got[3]), pr,
                           f32_tol(pr)))
    dk = monarch_cuda.dk_finish(plan, got[3], k_len)
    dk_ref = monarch.dk_finish_plain(plan, ref[3], k_len)
    compare(f"dk_finish {what}: dk", dk, dk_ref, f32_tol(dk_ref))
    again = monarch_cuda.direct_conv_bwd(plan, u, k_f, pre, post, dout)
    for name, a, r in zip(("du", "dpre", "dpost", "dk spectrum"), got, again):
        if a is not None and not torch.equal(a, r):
            raise AssertionError(f"direct_conv_bwd {what}: two runs differ in {name}")
    if not torch.equal(dk, monarch_cuda.dk_finish(plan, again[3], k_len)):
        raise AssertionError(f"dk_finish {what}: two runs differ")
    torch.cuda.synchronize()
    return fwd, bwd


def _check_direct_kernels(torch, g):
    """The direct kernels at the M2-BERT path's shape (B=128, H=768, L=128,
    N=256, bf16, ungated), then at every FFT size from 16 to 512 in f32 and
    bf16: gated and ungated, L = N/2 + 3 and L = N, B = 1, 3 and 20 (two
    chunks of the backward's batch walk at N = 256), H = 7 and 3."""
    from flashfftconv_tpu_torch.ops.plan import make_plan

    dev = torch.device("cuda")
    plan = make_plan(BERT_N_FFT, torch.bfloat16, device=dev)
    t = torch.arange(BERT_N_FFT, dtype=torch.float32)
    k = (torch.randn(BERT_D_MODEL, BERT_N_FFT, generator=g) * 0.02 * torch.exp(-t / 50)).to(dev)
    u, dout = ((torch.randn(BERT_B, BERT_D_MODEL, BERT_L, generator=g) * 0.02)
               .to(dev, torch.bfloat16) for _ in "ab")
    log(f"direct kernels: B={BERT_B} H={BERT_D_MODEL} L={BERT_L} N={BERT_N_FFT} bf16 ungated, "
        f"k_len={BERT_N_FFT} (a bidirectional kernel), spectrum factors {plan.factors}")
    fwd, bwd = _check_direct(torch, plan, "main path", u, k, None, None, dout)
    errs = {"direct_conv": fwd, "direct_conv_bwd": bwd}
    for n in DIRECT_SIZES:
        p = make_plan(n, torch.float32, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            for b, h, length, gated in ((1, 7, n // 2 + 3, True), (3, 7, n, False),
                                        (20, 3, n, True)):
                uu, pre, post, dd = (torch.randn(b, h, length, generator=g).to(dev, dtype)
                                     for _ in "abcd")
                kk = (torch.randn(h, n, generator=g) * 0.1).to(dev)
                gates = (pre, post) if gated else (None, None)
                what = (f"N={n} B={b} H={h} L={length} {'gated' if gated else 'ungated'} "
                        f"{dtype}")
                _check_direct(torch, p, what, uu, kk, *gates, dd)
    return errs


def _check_conv_bwd(torch, plan, what, u, k_f, pre, post, dout, k_len):
    """monarch_conv_bwd and dk_finish against conv_bwd_plain and
    dk_finish_plain; returns (du error, dk error)."""
    from flashfftconv_tpu_torch.ops import monarch, monarch_cuda

    got = monarch_cuda.monarch_conv_bwd(plan, u, k_f, pre, post, dout)
    ref = monarch.conv_bwd_plain(plan, u, k_f, pre, post, dout)
    low = u.dtype != torch.float32
    errs = []
    for name, a, r in zip(("du", "dpre", "dpost"), got[:3], ref[:3]):
        if r is not None:
            errs.append(compare(f"monarch_conv_bwd {what}: {name}", a, r,
                                lowp_tol(r) if low else f32_tol(r)))
    pr = torch.view_as_real(ref[3])
    compare(f"monarch_conv_bwd {what}: partials", torch.view_as_real(got[3]), pr, f32_tol(pr))
    dk_ref = monarch.dk_finish_plain(plan, ref[3], k_len)
    dk_err = compare(f"dk_finish {what}: dk", monarch_cuda.dk_finish(plan, got[3], k_len),
                     dk_ref, f32_tol(dk_ref))
    torch.cuda.synchronize()
    return errs[0], dk_err


def _check_dw_bwd(torch, what, x, w, dout, pad, is_bhl):
    """depthwise_bwd against depthwise_bwd_plain; dk and dbias are sums over
    B*L and are held to sum_tol of the terms' magnitudes. Returns du's error."""
    from flashfftconv_tpu_torch.ops import depthwise as dw

    du, dk, db = dw.depthwise_bwd(x, w, dout, pad, is_bhl)
    rdu, rdk, rdb = dw.depthwise_bwd_plain(x, w, dout, pad, is_bhl)
    _, adk, adb = dw.depthwise_bwd_plain(x.abs(), w, dout.abs(), pad, is_bhl)
    err = compare(f"depthwise_bwd {what}: du", du, rdu,
                  f32_tol(rdu) if x.dtype == torch.float32 else lowp_tol(rdu))
    compare(f"depthwise_bwd {what}: dk", dk, rdk, sum_tol(adk))
    compare(f"depthwise_bwd {what}: dbias", db, rdb, sum_tol(adb))
    torch.cuda.synchronize()
    return err


def _counters(names=("spectrum", "monarch_conv", "depthwise")):
    """The kernel wrappers of the given names, each with its launches count."""
    from flashfftconv_tpu_torch.ops import depthwise as dw
    from flashfftconv_tpu_torch.ops import monarch_cuda

    wrappers = {"spectrum": monarch_cuda.spectrum, "monarch_conv": monarch_cuda.monarch_conv,
                "monarch_conv_bwd": monarch_cuda.monarch_conv_bwd,
                "dk_finish": monarch_cuda.dk_finish, "depthwise": dw.depthwise,
                "depthwise_bwd": dw.depthwise_bwd, "butterfly": monarch_cuda.butterfly,
                "long_conv": monarch_cuda.long_conv_inner,
                "long_spectrum": monarch_cuda.long_spectrum,
                "long_conv_bwd": monarch_cuda.long_conv_bwd_inner,
                "long_dk_finish": monarch_cuda.long_dk_finish,
                "direct_conv": monarch_cuda.direct_conv,
                "direct_conv_bwd": monarch_cuda.direct_conv_bwd}
    return {name: wrappers[name] for name in names}


def _hyena_125m(torch, seed, dev):
    from flashfftconv_tpu_torch.models.lm import ConvLMHeadModel

    return ConvLMHeadModel(
        d_model=D_MODEL, n_layer=N_LAYER, d_inner=4 * D_MODEL, vocab_size=VOCAB, l_max=L_MAX,
        dtype=torch.bfloat16, device=dev, generator=torch.Generator().manual_seed(seed),
    )


def _corpus(np):
    """Byte ids of the repo's own Python sources, as examples/lm/train.py
    reads by default (ids < 256; the head stays sized at the GPT-2 vocab)."""
    paths = sorted(HERE.glob("flashfftconv_tpu*/**/*.py"))
    data = np.concatenate([np.frombuffer(p.read_bytes(), np.uint8) for p in paths])
    if data.size < B * (L_MAX + 1):
        raise AssertionError(f"corpus of {data.size} bytes is too small")
    return data.astype(np.int64)


def phase_train(torch, seed, np):
    """Hyena-125M (12 layers, d_model 768, l_max 8192, B=4, bf16 activations,
    f32 master weights, dropout on) takes TRAIN_WARMUP + TRAIN_TIMED steps of
    the examples/lm recipe on byte data."""
    from flashfftconv_tpu_torch.utils.train import lm_optimizer, make_train_step

    dev = torch.device("cuda")
    torch.manual_seed(seed)  # the dropout masks repeat from run to run
    model = _hyena_125m(torch, seed, dev).train()
    n_steps = TRAIN_WARMUP + TRAIN_TIMED
    opt, sched = lm_optimizer(model, lr=3e-4, weight_decay=0.1, warmup=2, steps=n_steps)
    step = make_train_step(model, opt, sched, clip=1.0)
    tokens = _corpus(np)
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(n_steps):
        offs = rng.integers(0, tokens.size - L_MAX - 1, B)
        xy = torch.from_numpy(np.stack([tokens[o : o + L_MAX + 1] for o in offs])).to(dev)
        batches.append((xy[:, :-1].contiguous(), xy[:, 1:].contiguous()))
    counters = _counters(TRAIN_LAUNCHES)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    losses, step_ms, per_step = [], [], []
    try:
        for x, y in batches:
            before = {name: fn.launches for name, fn in counters.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(x, y)
            loss = float(out["loss"])  # waits for the step
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss)
            per_step.append({name: fn.launches - before[name] for name, fn in counters.items()})
    except torch.cuda.OutOfMemoryError as e:
        raise AssertionError(f"Hyena-125M train step ran out of memory: peak "
                             f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB") from e
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite train loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train loss did not fall: {losses}")
    for i, counts in enumerate(per_step):
        if counts != TRAIN_LAUNCHES:
            raise AssertionError(f"step {i} launched {counts}, expected {TRAIN_LAUNCHES}")
    timed = step_ms[TRAIN_WARMUP:]
    med = float(np.median(timed))
    res = {
        "steps": n_steps,
        "losses": losses,
        "step_ms": step_ms,
        "step_ms_median": med,
        "step_ms_max": max(timed),
        "tokens_per_s": B * L_MAX / (med / 1e3),
        "launches": launches,
        "peak_memory_bytes": peak,
    }
    log(f"train: Hyena-125M B={B} L={L_MAX} bf16, {n_steps} steps (lr 3e-4, wd 0.1, clip 1.0, "
        f"warmup 2), losses {' '.join(f'{v:.4f}' for v in losses)}")
    log(f"train: step median {med:.2f} ms max {max(timed):.2f} ms over {TRAIN_TIMED} timed "
        f"steps ({res['tokens_per_s']:.0f} tokens/s), peak memory {peak / 2**30:.2f} GiB, "
        f"launches a step {per_step[-1]}")
    return res


def phase_grad_parity(torch, seed):
    """The 2-layer f32 LM of phase_parity with the same weights on the card
    (backward kernels) and on the CPU (plain backward): every parameter's
    grad, and the loss after one AdamW step."""
    from flashfftconv_tpu_torch.models.lm import ConvLMHeadModel
    from flashfftconv_tpu_torch.utils.metrics import cross_entropy

    kw = dict(d_model=128, n_layer=2, d_inner=512, vocab_size=256, l_max=1024,
              mixer_kwargs={"conv_dtype": torch.float32}, dtype=torch.float32)
    ids = torch.randint(0, 256, (2, 1025), generator=torch.Generator().manual_seed(seed + 2))
    grads, losses = {}, {}
    bwd0 = _counters(("monarch_conv_bwd", "depthwise_bwd"))
    before = {name: fn.launches for name, fn in bwd0.items()}
    for dev in ("cpu", "cuda"):
        model = ConvLMHeadModel(**kw, device=dev,
                                generator=torch.Generator().manual_seed(seed)).eval()
        x, y = ids[:, :-1].to(dev), ids[:, 1:].to(dev)
        loss = cross_entropy(model(x), y)
        loss.backward()
        grads[dev] = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
        opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=0.1)
        opt.step()
        with torch.no_grad():
            losses[dev] = (float(loss), float(cross_entropy(model(x), y)))
    for name, fn in bwd0.items():
        if fn.launches - before[name] != 2:
            raise AssertionError(f"{name} launched {fn.launches - before[name]} times, expected 2")
    worst = max(((g - grads["cpu"][n]).abs().max() / grads["cpu"][n].abs().max().clamp(min=1e-12),
                 n) for n, g in grads["cuda"].items())
    ratio, worst_name = float(worst[0]), worst[1]
    step_err = abs(losses["cuda"][1] - losses["cpu"][1]) / abs(losses["cpu"][1])
    log(f"grad_parity: 2-layer f32 LM, card (kernels) vs CPU (plain) over {len(grads['cpu'])} "
        f"params: max |dgrad| / max |grad| = {ratio:.3e} ({worst_name}), tol 1e-3; losses "
        f"{losses['cuda']} vs {losses['cpu']}, after one AdamW step rel err {step_err:.3e}, "
        f"tol 1e-4")
    if not ratio <= 1e-3:
        raise AssertionError(f"card and CPU grads disagree: {worst_name} at {ratio}")
    if not step_err <= 1e-4:
        raise AssertionError(f"card and CPU losses after one step disagree: {losses}")
    return {"grad_max_rel_err": ratio, "grad_worst_param": worst_name, "losses": losses,
            "loss_after_step_rel_err": step_err}


def phase_serve(torch, seed, np):
    from flashfftconv_tpu_torch.utils.generation import generate

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model = _hyena_125m(torch, seed, dev).eval()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"Hyena-125M: {n_params / 1e6:.2f}M params, built in {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(seed)
    ids = torch.zeros(B, L_MAX, dtype=torch.long)
    for i, n in enumerate(PROMPTS):
        ids[i, :n] = torch.from_numpy(rng.integers(0, VOCAB, n))
    ids = ids.to(dev)
    lengths = torch.tensor(PROMPTS, device=dev)

    fwd_ms = []

    def counted(tokens):
        """One timed forward (the caller reads its result on the host anyway)."""
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = model(tokens)
        torch.cuda.synchronize()
        fwd_ms.append((time.perf_counter() - t) * 1e3)
        return out

    with torch.inference_mode():
        model(ids)  # warm-up: cuBLAS handles, library loads
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counters = _counters()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        logits = counted(ids)
        torch.cuda.synchronize()
        score_s = time.perf_counter() - t0
        if logits.shape != (B, L_MAX, model.vocab_size) or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"bad logits: shape {tuple(logits.shape)} or non-finite values")
        del logits
        t0 = time.perf_counter()
        out = generate(counted, ids, NEW_TOKENS, L_MAX, temperature=0.0,
                       prompt_lengths=lengths)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    n_fwd = len(fwd_ms)
    for i, n in enumerate(PROMPTS):
        new = out[i, n : n + NEW_TOKENS]
        if not bool(((new >= 0) & (new < model.vocab_size)).all()):
            raise AssertionError(f"request {i}: generated ids out of range: {new.tolist()}")
        if not torch.equal(out[i, :n], ids[i, :n]):
            raise AssertionError(f"request {i}: prompt changed")
    if n_fwd != 1 + NEW_TOKENS:
        raise AssertionError(f"{n_fwd} forwards, expected {1 + NEW_TOKENS}")
    for name, count in launches.items():
        if count != N_LAYER * n_fwd:
            raise AssertionError(f"{name} launched {count} times in {n_fwd} forwards, "
                                 f"expected {N_LAYER} a forward")
    med = float(np.median(fwd_ms))
    res = {
        "forwards": n_fwd,
        "launches": launches,
        "forward_ms": fwd_ms,
        "forward_ms_median": med,
        "forward_ms_max": max(fwd_ms),
        "context_tokens_per_s": B * L_MAX / (med / 1e3),
        "score_s": score_s,
        "generate_s": gen_s,
        "generated_tokens_per_s": B * NEW_TOKENS / gen_s,
        "peak_memory_bytes": peak,
    }
    log(f"serve: {n_fwd} forwards, launches {launches}, forward median {med:.2f} ms max "
        f"{max(fwd_ms):.2f} ms ({res['context_tokens_per_s']:.0f} context tokens/s), "
        f"generate {gen_s:.3f} s for {B * NEW_TOKENS} tokens "
        f"({res['generated_tokens_per_s']:.1f} new tokens/s), peak memory {peak / 2**30:.2f} GiB")
    return res


def phase_parity(torch, seed):
    from flashfftconv_tpu_torch.models.lm import ConvLMHeadModel

    kw = dict(d_model=128, n_layer=2, d_inner=512, vocab_size=256, l_max=1024,
              mixer_kwargs={"conv_dtype": torch.float32}, dtype=torch.float32)
    models = {
        dev: ConvLMHeadModel(**kw, device=dev,
                             generator=torch.Generator().manual_seed(seed)).eval()
        for dev in ("cpu", "cuda")
    }
    ids = torch.randint(0, 256, (2, 1024), generator=torch.Generator().manual_seed(seed + 1))
    with torch.inference_mode():
        ref = models["cpu"](ids)
        got = models["cuda"](ids.cuda()).cpu()
    err = float((got - ref).abs().max())
    log(f"parity: 2-layer f32 LM, card (kernels) vs CPU (plain): max_abs_err={err:.3e} "
        f"tol=2e-3, |logits| <= {float(ref.abs().max()):.2f}")
    if not err <= 2e-3:
        raise AssertionError(f"card and CPU logits disagree: {err}")
    return {"logits_max_abs_err": err}


def phase_dna(torch, seed, np):
    """HyenaDNA large-1m at full width and depth answers DNA_REQUESTS scoring
    requests (B=1 each, one plan at FFT size 2 * l_max) through
    models.dna.score, then DNA_WARMUP + DNA_TIMED forwards at l_max bases."""
    from flashfftconv_tpu_torch.models import dna

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = dna.build_model(DNA_MODEL, dtype=torch.bfloat16, device=dev,
                            generator=torch.Generator().manual_seed(seed)).eval()
    cfg = dna.MODEL_CONFIGS[DNA_MODEL]
    if (cfg["d_model"], cfg["n_layer"], cfg["l_max"]) != (DNA_D_MODEL, DNA_N_LAYER, DNA_L_MAX):
        raise AssertionError(f"preset {DNA_MODEL} is {cfg}")
    n_params = sum(p.numel() for p in model.parameters())
    log(f"HyenaDNA {DNA_MODEL}: {n_params / 1e6:.2f}M params, d_model {DNA_D_MODEL}, "
        f"{DNA_N_LAYER} layers, l_max {DNA_L_MAX}, built in {time.perf_counter() - t0:.1f} s")
    genome = dna.synthetic_genome(seed)
    rng = np.random.default_rng(seed)
    counters = _counters(DNA_LAUNCHES)
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    requests = []
    for length in DNA_REQUESTS:
        off = int(rng.integers(0, genome.size - length))
        ids = torch.from_numpy(genome[off : off + length].astype(np.int64))[None].to(dev)
        before = {name: fn.launches for name, fn in counters.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = dna.score(model, ids)
        bits, nxt = float(out["bits_per_base"][0]), int(out["next_base"][0])  # waits
        ms = (time.perf_counter() - t0) * 1e3
        counts = {name: fn.launches - before[name] for name, fn in counters.items()}
        if not bool(out["finite"]) or not math.isfinite(bits):
            raise AssertionError(f"request of {length} bases: non-finite logits or score {bits}")
        if not 0 <= nxt < len(dna.DNA_VOCAB):
            raise AssertionError(f"request of {length} bases: next base {nxt} out of range")
        if counts != DNA_LAUNCHES:
            raise AssertionError(f"request of {length} bases launched {counts}, expected "
                                 f"{DNA_LAUNCHES}")
        requests.append({"bases": length, "bits_per_base": bits, "next_base": "ACGTN"[nxt],
                         "ms": ms})
        log(f"dna: request of {length} bases: {bits:.4f} bits/base, next base "
            f"{'ACGTN'[nxt]}, {ms:.1f} ms, launches {counts}")
    fwd_ms = []
    with torch.inference_mode():
        for _ in range(DNA_WARMUP + DNA_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = model(ids)
            torch.cuda.synchronize()
            fwd_ms.append((time.perf_counter() - t0) * 1e3)
        if logits.shape != (1, DNA_L_MAX, model.vocab_size) or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError(f"bad logits: shape {tuple(logits.shape)} or non-finite values")
        del logits
    launches = {name: fn.launches for name, fn in counters.items()}
    n_fwd = len(DNA_REQUESTS) + DNA_WARMUP + DNA_TIMED
    if launches != {name: n * n_fwd for name, n in DNA_LAUNCHES.items()}:
        raise AssertionError(f"{n_fwd} forwards launched {launches}, expected {DNA_LAUNCHES} each")
    peak = torch.cuda.max_memory_allocated()
    timed = fwd_ms[DNA_WARMUP:]
    med = float(np.median(timed))
    res = {"requests": requests, "forwards": n_fwd, "launches": launches, "forward_ms": fwd_ms,
           "forward_ms_median": med, "forward_ms_max": max(timed),
           "tokens_per_ms": DNA_L_MAX / med, "peak_memory_bytes": peak}
    log(f"dna: forward at {DNA_L_MAX} bases (B=1, bf16): median {med:.2f} ms max "
        f"{max(timed):.2f} ms over {DNA_TIMED} timed forwards, {res['tokens_per_ms']:.1f} "
        f"tokens/ms, peak memory {peak / 2**30:.2f} GiB, launches a forward {DNA_LAUNCHES}")
    return res


def _dna_train_step(torch, model):
    """The examples/hyena_dna train step over model: clip 1.0, then AdamW at
    lr 6e-4, weight decay 0.1, no schedule; no dropout (eval mode)."""
    from flashfftconv_tpu_torch.utils.train import dna_optimizer, make_train_step

    return make_train_step(model.eval(), dna_optimizer(model), None, clip=1.0)


def phase_dna_train(torch, seed, np):
    """HyenaDNA large-1m at full width and depth takes DNA_TRAIN_WARMUP +
    DNA_TRAIN_TIMED steps at B=1 and l_max bases."""
    from flashfftconv_tpu_torch.models import dna
    from flashfftconv_tpu_torch.utils.data import lm_batches

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    levers = dna.train_config(DNA_MODEL)
    model = dna.build_model(DNA_MODEL, dtype=torch.bfloat16, device=dev,
                            generator=torch.Generator().manual_seed(seed), **levers)
    step = _dna_train_step(torch, model)
    batches = lm_batches(dna.synthetic_genome(seed), 1, DNA_L_MAX, np.random.default_rng(seed))
    n_steps = DNA_TRAIN_WARMUP + DNA_TRAIN_TIMED
    counters = _counters(DNA_TRAIN_LAUNCHES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    losses, step_ms, per_step = [], [], []
    try:
        for _ in range(n_steps):
            x, y = (torch.from_numpy(a.astype(np.int64)).to(dev) for a in next(batches))
            before = {name: fn.launches for name, fn in counters.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(x, y)
            loss = float(out["loss"])  # waits for the step
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss)
            per_step.append({name: fn.launches - before[name] for name, fn in counters.items()})
    except torch.cuda.OutOfMemoryError as e:
        raise AssertionError(f"HyenaDNA {DNA_MODEL} train step ran out of memory with levers "
                             f"{levers}: peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
                             "GiB") from e
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite train loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train loss did not fall: {losses}")
    for i, counts in enumerate(per_step):
        if counts != DNA_TRAIN_LAUNCHES:
            raise AssertionError(f"step {i} launched {counts}, expected {DNA_TRAIN_LAUNCHES}")
    timed = step_ms[DNA_TRAIN_WARMUP:]
    med = float(np.median(timed))
    res = {"steps": n_steps, "levers": levers, "losses": losses, "step_ms": step_ms,
           "step_ms_median": med, "step_ms_max": max(timed),
           "tokens_per_s": DNA_L_MAX / (med / 1e3), "launches": launches,
           "peak_memory_bytes": peak}
    log(f"dna_train: HyenaDNA {DNA_MODEL} B=1 L={DNA_L_MAX} bf16, levers {levers}, {n_steps} "
        f"steps (lr 6e-4, wd 0.1, clip 1.0), losses {' '.join(f'{v:.4f}' for v in losses)}")
    log(f"dna_train: step median {med:.2f} ms max {max(timed):.2f} ms over {DNA_TRAIN_TIMED} "
        f"timed steps ({res['tokens_per_s']:.0f} tokens/s), peak memory {peak / 2**30:.2f} GiB, "
        f"launches a step {per_step[-1]}")
    del model, step
    torch.cuda.empty_cache()
    return res


def _all_levers(torch):
    """Every memory lever of the 1M-base recipe as build_model overrides; the
    two dtype levers at f32, so that each lever is exact and the model must
    agree with the lever-free one."""
    return dict(
        remat=True, scan_blocks=True, inner_remat=True, mlp_l_chunks=8,
        mixer_kwargs={"conv_dtype": torch.float32, "conv_h_chunks": 4, "proj_l_chunks": 8,
                      "proj_out_f32": True, "filter_output_dtype": torch.float32,
                      "filter_args": {"emb_dim": 5, "mlp_dtype": torch.float32}})


def _loss_and_grads(torch, model, ids):
    from flashfftconv_tpu_torch.utils.metrics import cross_entropy

    model.zero_grad(set_to_none=True)
    loss = cross_entropy(model(ids[:, :-1]), ids[:, 1:])
    loss.backward()
    return float(loss), {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def _worst_grad(grads, ref):
    """(largest max |dgrad| / max |grad| over the parameters, its name)."""
    worst = max(((g.cpu() - ref[n].cpu()).abs().max() / ref[n].cpu().abs().max().clamp(min=1e-12),
                 n) for n, g in grads.items())
    return float(worst[0]), worst[1]


def phase_long_parity(torch, seed, np):
    """A 2-layer f32 HyenaDNA at l_max 65536 (FFT size 131072) with the same
    weights on the card (long kernels) and on the CPU (plain versions):
    logits, then grads (twice on the card, bit for bit); then every memory
    lever on against none, on the card."""
    from flashfftconv_tpu_torch.models import dna

    l_max = 65536
    models = {
        dev: dna.build_model("tiny-1k", d_model=64, n_layer=2, l_max=l_max, dtype=torch.float32,
                             mixer_kwargs={"conv_dtype": torch.float32}, device=dev,
                             generator=torch.Generator().manual_seed(seed)).eval()
        for dev in ("cpu", "cuda")
    }
    ids = torch.from_numpy(dna.synthetic_genome(seed + 1, n=l_max).astype(np.int64))[None]
    n0 = _counters(("long_conv",))["long_conv"].launches
    with torch.inference_mode():
        ref = models["cpu"](ids)
        got = models["cuda"](ids.cuda()).cpu()
    if _counters(("long_conv",))["long_conv"].launches != n0 + 2:
        raise AssertionError("the card's forward did not run the long conv once a layer")
    err = float((got - ref).abs().max())
    log(f"long_parity: 2-layer f32 HyenaDNA at {l_max} bases, card (long kernels) vs CPU "
        f"(plain): max_abs_err={err:.3e} tol=2e-3, |logits| <= {float(ref.abs().max()):.2f}")
    if not err <= 2e-3:
        raise AssertionError(f"card and CPU logits disagree: {err}")
    res = {"logits_max_abs_err": err}

    ids = torch.from_numpy(dna.synthetic_genome(seed + 2, n=l_max + 1).astype(np.int64))[None]
    bwd = _counters(("long_conv_bwd", "long_dk_finish"))
    before = {name: fn.launches for name, fn in bwd.items()}
    loss_cpu, grads_cpu = _loss_and_grads(torch, models["cpu"], ids)
    loss_card, grads_card = _loss_and_grads(torch, models["cuda"], ids.cuda())
    _, grads_again = _loss_and_grads(torch, models["cuda"], ids.cuda())
    for name, fn in bwd.items():
        if fn.launches - before[name] != 4:
            raise AssertionError(f"{name} launched {fn.launches - before[name]} times in two "
                                 "backwards of 2 layers, expected 4")
    ratio, worst = _worst_grad(grads_card, grads_cpu)
    # The embedding table's grad is excepted: PyTorch's embedding backward adds
    # the 65536 rows' grads into 8 table rows with float atomics, in an order
    # that changes from run to run. Every other grad comes through the port's
    # kernels, matmuls and elementwise passes, none of which uses atomics.
    differ = [n for n, gr in grads_card.items()
              if n != "embeddings.weight" and not torch.equal(gr, grads_again[n])]
    log(f"long_parity: grads, card (long backward kernels) vs CPU (plain) over "
        f"{len(grads_cpu)} params: max |dgrad| / max |grad| = {ratio:.3e} ({worst}), tol 1e-3; "
        f"loss {loss_card:.6f} vs {loss_cpu:.6f}; a second backward on the card differs in "
        f"{len(differ)} of the {len(grads_cpu) - 1} params outside the embedding table {differ}")
    if not ratio <= 1e-3:
        raise AssertionError(f"card and CPU grads disagree: {worst} at {ratio}")
    if differ:
        raise AssertionError(f"two backwards on the card differ in {differ}")
    res.update(grad_max_rel_err=ratio, grad_worst_param=worst)
    del models, grads_cpu, grads_card, grads_again

    l_max, out = 131072, {}
    ids = torch.from_numpy(dna.synthetic_genome(seed + 3, n=l_max + 1).astype(np.int64))[None]
    ids = ids.cuda()
    levers = _all_levers(torch)
    for name, kw in (("none", {"mixer_kwargs": {"conv_dtype": torch.float32}}), ("all", levers)):
        model = dna.build_model("tiny-1k", d_model=DNA_D_MODEL, n_layer=2, l_max=l_max,
                                dtype=torch.float32, device="cuda",
                                generator=torch.Generator().manual_seed(seed), **kw).eval()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out[name] = (*_loss_and_grads(torch, model, ids), torch.cuda.max_memory_allocated())
        del model
        torch.cuda.empty_cache()
    ratio, worst = _worst_grad(out["all"][1], out["none"][1])
    loss_err = abs(out["all"][0] - out["none"][0]) / abs(out["none"][0])
    log(f"long_parity: 2-layer d_model {DNA_D_MODEL} f32 HyenaDNA at {l_max} bases on the card, "
        f"every lever on ({levers}) vs none: loss {out['all'][0]:.6f} vs "
        f"{out['none'][0]:.6f} (rel err {loss_err:.3e}), max |dgrad| / max |grad| = {ratio:.3e} "
        f"({worst}), tol 1e-4; peak memory {out['all'][2] / 2**30:.2f} vs "
        f"{out['none'][2] / 2**30:.2f} GiB")
    if not (ratio <= 1e-4 and loss_err <= 1e-4):
        raise AssertionError(f"levers on and off disagree: loss {loss_err}, {worst} at {ratio}")
    res.update(levers_grad_max_rel_err=ratio, levers_loss_rel_err=loss_err,
               levers_peak_memory_bytes=out["all"][2], no_levers_peak_memory_bytes=out["none"][2])
    return res


def _m2_bert(torch, seed, dev):
    from flashfftconv_tpu_torch.models import bert

    model = bert.build_model(BERT_MODEL, dtype=torch.bfloat16, device=dev,
                             generator=torch.Generator().manual_seed(seed))
    cfg = bert.PRESETS[BERT_MODEL]
    if (cfg["d_model"], cfg["n_layer"], cfg["l_max"]) != (BERT_D_MODEL, BERT_N_LAYER, BERT_L):
        raise AssertionError(f"preset {BERT_MODEL} is {cfg}")
    return model


def phase_bert(torch, seed, np):
    """M2-BERT base-110M at full width and depth answers BERT_REQUESTS
    fill-mask requests through models.bert.fill_mask, then BERT_WARMUP +
    BERT_TIMED forwards at B=128, L=128."""
    from flashfftconv_tpu_torch.models import bert
    from flashfftconv_tpu_torch.utils.data import mlm_batches

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = _m2_bert(torch, seed, dev).eval()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"M2-BERT {BERT_MODEL}: {n_params / 1e6:.2f}M params, d_model {BERT_D_MODEL}, "
        f"{BERT_N_LAYER} layers, l_max {BERT_L}, built in {time.perf_counter() - t0:.1f} s")
    tokens = _corpus(np)
    rng = np.random.default_rng(seed)
    counters = _counters(BERT_LAUNCHES)
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    requests = []
    for b, length in BERT_REQUESTS:
        x, labels = (torch.from_numpy(a).to(dev) for a in next(mlm_batches(tokens, b, length, rng)))
        before = {name: fn.launches for name, fn in counters.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = bert.fill_mask(model, x, labels)
        acc = float((out["accuracy"] * (labels >= 0).sum(1)).sum() / (labels >= 0).sum())  # waits
        ms = (time.perf_counter() - t0) * 1e3
        counts = {name: fn.launches - before[name] for name, fn in counters.items()}
        top1 = out["top1"]
        if not bool(out["finite"]) or top1.shape != (b, length):
            raise AssertionError(f"request {(b, length)}: non-finite logits or top-1 of shape "
                                 f"{tuple(top1.shape)}")
        if not bool(((top1 >= 0) & (top1 < model.vocab_size)).all()):
            raise AssertionError(f"request {(b, length)}: top-1 ids out of range")
        if counts != BERT_LAUNCHES:
            raise AssertionError(f"request {(b, length)} launched {counts}, expected "
                                 f"{BERT_LAUNCHES}")
        requests.append({"batch": b, "length": length, "masked": int((labels >= 0).sum()),
                         "masked_accuracy": acc, "ms": ms})
        log(f"bert: fill-mask request B={b} L={length}: {requests[-1]['masked']} masked, "
            f"top-1 accuracy {acc:.4f}, {ms:.1f} ms, launches {counts}")
    x = next(mlm_batches(tokens, BERT_B, BERT_L, rng))[0]
    x = torch.from_numpy(x).to(dev)
    fwd_ms = []
    with torch.inference_mode():
        for _ in range(BERT_WARMUP + BERT_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = model(x)
            torch.cuda.synchronize()
            fwd_ms.append((time.perf_counter() - t0) * 1e3)
        if logits.shape != (BERT_B, BERT_L, model.vocab_size) or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError(f"bad logits: shape {tuple(logits.shape)} or non-finite values")
        del logits
    launches = {name: fn.launches for name, fn in counters.items()}
    n_fwd = len(BERT_REQUESTS) + BERT_WARMUP + BERT_TIMED
    if launches != {name: n * n_fwd for name, n in BERT_LAUNCHES.items()}:
        raise AssertionError(f"{n_fwd} forwards launched {launches}, expected {BERT_LAUNCHES} "
                             "each")
    peak = torch.cuda.max_memory_allocated()
    timed = fwd_ms[BERT_WARMUP:]
    med = float(np.median(timed))
    res = {"requests": requests, "forwards": n_fwd, "launches": launches, "forward_ms": fwd_ms,
           "forward_ms_median": med, "forward_ms_max": max(timed),
           "tokens_per_ms": BERT_B * BERT_L / med, "seqs_per_s": BERT_B / (med / 1e3),
           "peak_memory_bytes": peak}
    log(f"bert: forward at B={BERT_B} L={BERT_L} (bf16): median {med:.2f} ms max "
        f"{max(timed):.2f} ms over {BERT_TIMED} timed forwards, {res['tokens_per_ms']:.1f} "
        f"tokens/ms, {res['seqs_per_s']:.1f} seqs/s, peak memory {peak / 2**30:.2f} GiB, "
        f"launches a forward {BERT_LAUNCHES}")
    del model
    torch.cuda.empty_cache()
    return res


def _bert_train_step(torch, model):
    """The examples/bert train step over model: clip 1.0, then AdamW at lr
    8e-4, weight decay 1e-5 on every parameter; the MLM loss and accuracy
    over the masked positions."""
    from flashfftconv_tpu_torch.utils.train import bert_optimizer, make_train_step, mlm_loss

    return make_train_step(model, bert_optimizer(model), None, clip=1.0, loss_fn=mlm_loss)


def phase_bert_train(torch, seed, np):
    """M2-BERT base-110M at full width and depth takes BERT_TRAIN_WARMUP +
    BERT_TRAIN_TIMED steps at B=128, L=128, dropout on."""
    from flashfftconv_tpu_torch.utils.data import mlm_batches

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    torch.manual_seed(seed)  # the dropout masks repeat from run to run
    model = _m2_bert(torch, seed, dev).train()
    step = _bert_train_step(torch, model)
    batches = mlm_batches(_corpus(np), BERT_B, BERT_L, np.random.default_rng(seed))
    n_steps = BERT_TRAIN_WARMUP + BERT_TRAIN_TIMED
    counters = _counters(BERT_TRAIN_LAUNCHES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    losses, accs, step_ms, per_step = [], [], [], []
    for _ in range(n_steps):
        x, y = (torch.from_numpy(a).to(dev) for a in next(batches))
        before = {name: fn.launches for name, fn in counters.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(x, y)
        loss = float(out["loss"])  # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        accs.append(float(out["accuracy"]))
        per_step.append({name: fn.launches - before[name] for name, fn in counters.items()})
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite MLM loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"MLM loss did not fall: {losses}")
    for i, counts in enumerate(per_step):
        if counts != BERT_TRAIN_LAUNCHES:
            raise AssertionError(f"step {i} launched {counts}, expected {BERT_TRAIN_LAUNCHES}")
    timed = step_ms[BERT_TRAIN_WARMUP:]
    med = float(np.median(timed))
    res = {"steps": n_steps, "losses": losses, "accuracies": accs, "step_ms": step_ms,
           "step_ms_median": med, "step_ms_max": max(timed),
           "tokens_per_s": BERT_B * BERT_L / (med / 1e3), "launches": launches,
           "peak_memory_bytes": peak}
    log(f"bert_train: M2-BERT {BERT_MODEL} B={BERT_B} L={BERT_L} bf16, dropout 0.1, {n_steps} "
        f"steps (lr 8e-4, wd 1e-5, clip 1.0), MLM losses {' '.join(f'{v:.4f}' for v in losses)}, "
        f"accuracies {' '.join(f'{v:.4f}' for v in accs)}")
    log(f"bert_train: step median {med:.2f} ms max {max(timed):.2f} ms over {BERT_TRAIN_TIMED} "
        f"timed steps ({res['tokens_per_s']:.0f} tokens/s), peak memory {peak / 2**30:.2f} GiB, "
        f"launches a step {per_step[-1]}")
    del model, step
    torch.cuda.empty_cache()
    return res


def phase_bert_parity(torch, seed, np):
    """A 2-layer f32 M2BertForMaskedLM (d_model 128, l_max 128, bidirectional
    kernels, residual long conv) with the same weights on the card (direct
    kernels) and on the CPU (plain versions): logits, the masked-LM grads,
    and a second backward on the card bit for bit. B = 20 spans two chunks
    of the direct backward's batch walk."""
    from flashfftconv_tpu_torch.models.bert import M2BertForMaskedLM
    from flashfftconv_tpu_torch.utils.data import mlm_batches
    from flashfftconv_tpu_torch.utils.metrics import cross_entropy

    kw = dict(vocab_size=300, d_model=128, n_layer=2, d_inner=512, l_max=128, mlp_nblocks=0,
              tie_mlm_head=True, conv_dtype=torch.float32)
    models = {dev: M2BertForMaskedLM(**kw, device=dev,
                                     generator=torch.Generator().manual_seed(seed)).eval()
              for dev in ("cpu", "cuda")}
    x, y = (torch.from_numpy(a) for a in next(mlm_batches(_corpus(np), 20, 128,
                                                          np.random.default_rng(seed + 1))))
    n0 = _counters(("direct_conv",))["direct_conv"].launches
    with torch.inference_mode():
        ref = models["cpu"](x)
        got = models["cuda"](x.cuda()).cpu()
    if _counters(("direct_conv",))["direct_conv"].launches != n0 + 4:
        raise AssertionError("the card's forward did not run two direct convs a layer")
    err = float((got - ref).abs().max())
    log(f"bert_parity: 2-layer f32 M2-BERT at L=128, B=20, card (direct kernels) vs CPU (plain): "
        f"max_abs_err={err:.3e} tol=2e-3, |logits| <= {float(ref.abs().max()):.2f}")
    if not err <= 2e-3:
        raise AssertionError(f"card and CPU logits disagree: {err}")

    def loss_and_grads(model, dev):
        model.zero_grad(set_to_none=True)
        loss = cross_entropy(model(x.to(dev)), y.to(dev), -100)
        loss.backward()
        return float(loss), {n: p.grad.detach().clone() for n, p in model.named_parameters()
                             if p.grad is not None}

    bwd = _counters(("direct_conv_bwd",))["direct_conv_bwd"]
    n0 = bwd.launches
    loss_cpu, grads_cpu = loss_and_grads(models["cpu"], "cpu")
    loss_card, grads_card = loss_and_grads(models["cuda"], "cuda")
    _, grads_again = loss_and_grads(models["cuda"], "cuda")
    if bwd.launches - n0 != 8:
        raise AssertionError(f"direct_conv_bwd launched {bwd.launches - n0} times in two "
                             "backwards of 2 layers, expected 8")
    if set(grads_card) != set(grads_cpu):
        raise AssertionError("the card and the CPU grads cover other parameters")
    ratio, worst = _worst_grad(grads_card, grads_cpu)
    # The embedding tables' grads are excepted: PyTorch's embedding backward
    # adds rows with float atomics, in an order that changes from run to run.
    differ = [n for n, gr in grads_card.items()
              if "embeddings" not in n and not torch.equal(gr, grads_again[n])]
    log(f"bert_parity: masked-LM grads, card (direct backward kernels) vs CPU (plain) over "
        f"{len(grads_cpu)} params: max |dgrad| / max |grad| = {ratio:.3e} ({worst}), tol 1e-3; "
        f"loss {loss_card:.6f} vs {loss_cpu:.6f}; a second backward on the card differs in "
        f"{len(differ)} params outside the embedding tables {differ}")
    if not ratio <= 1e-3:
        raise AssertionError(f"card and CPU grads disagree: {worst} at {ratio}")
    if differ:
        raise AssertionError(f"two backwards on the card differ in {differ}")
    return {"logits_max_abs_err": err, "grad_max_rel_err": ratio, "grad_worst_param": worst}


def _kind(name: str) -> str:
    for kind, keys in (
        ("butterfly", ("butterfly_fwd_kernel", "butterfly_inv_kernel")),
        ("long_conv_bwd", ("long_conv_bwd_kernel",)),
        ("long_dk_finish", ("long_dk_finish_kernel",)),
        ("long_conv", ("long_conv_kernel",)),
        ("long_spectrum", ("long_spectrum_kernel",)),
        ("direct_conv_bwd", ("direct_conv_bwd_kernel",)),
        ("direct_conv", ("direct_conv_kernel",)),
        ("monarch_conv_bwd", ("monarch_conv_bwd_kernel",)),
        ("dk_finish", ("dk_finish_kernel",)),
        ("monarch_conv", ("monarch_conv_kernel",)),
        ("spectrum", ("spectrum_kernel",)),
        ("depthwise_bwd", ("depthwise_bwd_",)),
        ("depthwise", ("depthwise_",)),
        ("matmul", ("gemm", "cutlass", "xmma", "cublas", "nvjet", "sm90_")),
        ("copy or cast", ("copy_kernel",)),
        ("optimizer (foreach)", ("multi_tensor_apply",)),
    ):
        if any(k in name for k in keys):
            return kind
    return "other"


def _trace(torch, what, fn):
    """Device time by kernel and by kind over one call of fn (after a warm-up
    call), with torch.profiler, and the wall time of one more call with the
    profiler off. The idle share of an unprofiled call is estimated from the
    two: the profiled call's device busy time over the unprofiled wall."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    unprofiled_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for ev in prof.events():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            k = kernels.setdefault(ev.name, [0.0, 0])
            k[0] += ev.device_time_total / 1e3 if hasattr(ev, "device_time_total") \
                else ev.cuda_time_total / 1e3
            k[1] += 1
    if not kernels:
        raise AssertionError("the profiler recorded no device activity")
    busy = sum(t for t, _ in kernels.values())
    by_kind = {}
    for name, (t, n) in kernels.items():
        kind = by_kind.setdefault(_kind(name), [0.0, 0])
        kind[0] += t
        kind[1] += n
    log(f"profile: {what}, wall {wall_ms:.2f} ms (profiler on), device busy {busy:.2f} ms "
        f"({busy / wall_ms:.1%}); the next call unprofiled {unprofiled_ms:.2f} ms of wall "
        f"(idle share estimated {max(0.0, 1 - busy / unprofiled_ms):.1%})")
    for kind, (t, n) in sorted(by_kind.items(), key=lambda kv: -kv[1][0]):
        log(f"  {kind}: {t:.3f} ms in {n} launches ({t / busy:.1%} of device time)")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    for name, (t, n) in top:
        log(f"    {t:8.3f} ms {n:4d}x {name[:110]}")
    return {"wall_ms": wall_ms, "unprofiled_wall_ms": unprofiled_ms, "device_busy_ms": busy,
            "by_kind_ms": {k: v[0] for k, v in by_kind.items()},
            "by_kind_launches": {k: v[1] for k, v in by_kind.items()},
            "top": [(name, t, n) for name, (t, n) in top]}


def phase_profile(torch, seed):
    """Device time by kernel over one Hyena-125M serving forward and one
    train step (dropout on, the examples/lm optimizer)."""
    from flashfftconv_tpu_torch.utils.train import lm_optimizer, make_train_step

    model = _hyena_125m(torch, seed, "cuda")
    ids = torch.randint(0, 256, (B, L_MAX + 1), generator=torch.Generator().manual_seed(seed))
    ids = ids.cuda()
    x, y = ids[:, :-1].contiguous(), ids[:, 1:].contiguous()
    res = {}
    with torch.inference_mode():
        res["forward"] = _trace(torch, "one serving forward", lambda: model.eval()(x))
    opt, sched = lm_optimizer(model, lr=3e-4, weight_decay=0.1, warmup=2, steps=10)
    step = make_train_step(model.train(), opt, sched, clip=1.0)
    res["train_step"] = _trace(torch, "one train step", lambda: step(x, y))
    del model, opt, sched, step
    torch.cuda.empty_cache()
    from flashfftconv_tpu_torch.models import dna

    dna_model = dna.build_model(DNA_MODEL, dtype=torch.bfloat16, device="cuda",
                                generator=torch.Generator().manual_seed(seed)).eval()
    bases = torch.from_numpy(dna.synthetic_genome(seed)[:DNA_L_MAX].astype("int64"))[None].cuda()
    with torch.inference_mode():
        res["dna_forward"] = _trace(torch, f"one HyenaDNA {DNA_MODEL} forward at {DNA_L_MAX} "
                                    "bases", lambda: dna_model(bases))
    del dna_model
    torch.cuda.empty_cache()
    dna_model = dna.build_model(DNA_MODEL, dtype=torch.bfloat16, device="cuda",
                                generator=torch.Generator().manual_seed(seed),
                                **dna.train_config(DNA_MODEL))
    step = _dna_train_step(torch, dna_model)
    targets = torch.roll(bases, -1, dims=1)
    res["dna_train_step"] = _trace(torch, f"one HyenaDNA {DNA_MODEL} train step at {DNA_L_MAX} "
                                   "bases", lambda: step(bases, targets))
    del dna_model, step
    torch.cuda.empty_cache()
    import numpy as np
    from flashfftconv_tpu_torch.utils.data import mlm_batches

    model = _m2_bert(torch, seed, "cuda")
    x, y = (torch.from_numpy(a).cuda() for a in next(mlm_batches(
        _corpus(np), BERT_B, BERT_L, np.random.default_rng(seed))))
    with torch.inference_mode():
        res["bert_forward"] = _trace(torch, f"one M2-BERT {BERT_MODEL} forward at B={BERT_B} "
                                     f"L={BERT_L}", lambda: model.eval()(x))
    step = _bert_train_step(torch, model.train())
    res["bert_train_step"] = _trace(torch, f"one M2-BERT {BERT_MODEL} train step at B={BERT_B} "
                                    f"L={BERT_L}", lambda: step(x, y))
    return res


def _time_ms(torch, fn, iters=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _fft_flops(m: int, n_stages: int) -> float:
    """f32 operations of one M-point complex FFT as the kernels do it: radix-2
    line DFTs (5 M log2 M) and the twiddles between stages (6 M each)."""
    return 5 * m * math.log2(m) + 6 * m * (n_stages - 1)


def phase_timing(torch, g):
    import torch.nn.functional as F

    from flashfftconv_tpu_torch.ops import monarch, monarch_cuda
    from flashfftconv_tpu_torch.ops import depthwise as dw
    from flashfftconv_tpu_torch.ops.plan import make_plan

    dev = torch.device("cuda")
    plan = make_plan(N_FFT, torch.bfloat16, device=dev)
    k, u, x, w, bias = _kernel_inputs(torch, g, dev)
    m, ns = plan.inner, plan.n_stages
    k_f = monarch_cuda.spectrum(plan, k)
    res = {}
    with torch.inference_mode():
        # spectrum: read f32 taps, write f32 half spectrum; one FFT and a split a row
        nbytes = k.numel() * 4 + k_f.numel() * 8
        flops = D_MODEL * (_fft_flops(m, ns) + 20 * (m // 2))
        res["spectrum"] = dict(
            ms=_time_ms(torch, lambda: monarch_cuda.spectrum(plan, k)),
            plain_ms=_time_ms(torch, lambda: monarch.kernel_spectrum(plan, k), iters=5),
            library_ms=_time_ms(torch, lambda: torch.fft.rfft(k, n=N_FFT)),
            bound=_bound(nbytes, flops),
        )
        # monarch_conv: read u and k_f, write y; two FFTs and the pointwise pass a row
        nbytes = u.numel() * 2 * 2 + k_f.numel() * 8
        flops = B * D_MODEL * (2 * _fft_flops(m, ns) + 40 * (m // 2) + 4 * L_MAX)
        res["monarch_conv"] = dict(
            ms=_time_ms(torch, lambda: monarch_cuda.monarch_conv(plan, u, k_f)),
            plain_ms=_time_ms(torch, lambda: monarch.conv_with_spectrum(plan, u, k_f), iters=5),
            library_ms=_time_ms(torch, lambda: torch.fft.irfft(
                torch.fft.rfft(u.float(), n=N_FFT) * k_f, n=N_FFT)[..., :L_MAX].to(u.dtype)),
            bound=_bound(nbytes, flops),
        )
        # depthwise: read x, write out; 2K operations an output
        nbytes = x.numel() * 2 * 2
        flops = x.numel() * (2 * 3 + 1)
        wb = w[:, None, :].to(x.dtype)
        res["depthwise"] = dict(
            ms=_time_ms(torch, lambda: dw.depthwise(x, w, bias, (2, 0), True)),
            plain_ms=_time_ms(torch, lambda: dw.depthwise_plain(x, w, bias, (2, 0), True),
                              iters=5),
            library_ms=_time_ms(torch, lambda: F.conv1d(
                x, wb, bias.to(x.dtype), padding=2, groups=x.shape[1])[..., :L_MAX]),
            bound=_bound(nbytes, flops),
        )
        # monarch_conv_bwd (ungated, as on the main path): the function reads
        # u, dout and k_f and writes du and one (H, M+1) dk spectrum, summed
        # over B as the TPU kernel does on chip; three FFTs a row, about 60
        # operations a frequency pair, 4 a sample and the batch sum besides.
        # The (B, H, M+1) partials this design writes instead, and dk_finish
        # reads back, are the design's own traffic: reported as overhead_ms,
        # not counted in either bound.
        dout = (torch.randn(u.shape, generator=g) * 0.02).to(dev, u.dtype)
        parts = monarch_cuda.monarch_conv_bwd(plan, u, k_f, None, None, dout)[3]
        spec_bytes = k_f.numel() * 8
        overhead_ms = (parts.numel() * 8 - spec_bytes) / HBM_BYTES_PER_S * 1e3
        nbytes = u.numel() * 2 * 3 + k_f.numel() * 8 + spec_bytes
        flops = B * D_MODEL * (3 * _fft_flops(m, ns) + 60 * (m // 2) + 4 * L_MAX + 2 * (m + 1))

        def fft_bwd():
            g_f, u_f = torch.fft.rfft(dout.float(), n=N_FFT), torch.fft.rfft(u.float(), n=N_FFT)
            du = torch.fft.irfft(g_f * k_f.conj(), n=N_FFT)[..., :L_MAX].to(u.dtype)
            return du, g_f * u_f.conj()

        res["monarch_conv_bwd"] = dict(
            ms=_time_ms(torch, lambda: monarch_cuda.monarch_conv_bwd(plan, u, k_f, None, None,
                                                                      dout)),
            plain_ms=_time_ms(torch, lambda: monarch.conv_bwd_plain(plan, u, k_f, None, None,
                                                                    dout), iters=5),
            library_ms=_time_ms(torch, fft_bwd),
            bound=_bound(nbytes, flops),
            overhead_ms=overhead_ms,
        )
        # dk_finish: the function reads one (H, M+1) dk spectrum and writes
        # dk; the unsplit (20 a pair) and one inverse FFT a channel
        nbytes = spec_bytes + D_MODEL * L_MAX * 4
        flops = D_MODEL * (_fft_flops(m, ns) + 20 * (m // 2))
        res["dk_finish"] = dict(
            ms=_time_ms(torch, lambda: monarch_cuda.dk_finish(plan, parts, L_MAX)),
            plain_ms=_time_ms(torch, lambda: monarch.dk_finish_plain(plan, parts, L_MAX),
                              iters=5),
            library_ms=_time_ms(torch, lambda: torch.fft.irfft(parts.sum(0), n=N_FFT)[
                ..., :L_MAX]),
            bound=_bound(nbytes, flops),
            overhead_ms=overhead_ms,
        )
        # depthwise_bwd: read x and dout, write du; 2K operations a position
        # for du, 2K for dk and 1 for dbias
        dy = torch.randn(x.shape, generator=g).to(dev, x.dtype)
        nbytes = x.numel() * 2 * 3
        flops = x.numel() * (4 * 3 + 1)
        dy_full = F.pad(dy, (0, 2))  # the grouped conv with padding 2 outputs L + 2

        def conv_bwd():
            return torch.ops.aten.convolution_backward(
                dy_full, x, wb, [x.shape[1]], [1], [2], [1], False, [0], x.shape[1],
                [True, True, True])

        res["depthwise_bwd"] = dict(
            ms=_time_ms(torch, lambda: dw.depthwise_bwd(x, w, dy, (2, 0), True)),
            plain_ms=_time_ms(torch, lambda: dw.depthwise_bwd_plain(x, w, dy, (2, 0), True),
                              iters=5),
            library_ms=_time_ms(torch, conv_bwd),
            bound=_bound(nbytes, flops),
        )
    del k, u, x, k_f, dout, parts, dy, dy_full
    torch.cuda.empty_cache()
    for rows in (_time_direct(torch, g), _time_long(torch, g)):
        if set(rows) & set(res):
            raise AssertionError(f"timing rows named twice: {sorted(set(rows) & set(res))}")
        res.update(rows)
    for name, r in res.items():
        extra = (f", the design's own traffic beyond the bound {r['overhead_ms']:.4f} ms"
                 if "overhead_ms" in r else "")
        if "design_ops_ms" in r:
            extra += f", the design's own operations at the f32 peak {r['design_ops_ms']:.4f} ms"
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        log(f"timing {name}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
            f"{lib}, bound {r['bound'][0]:.4f} ms ({r['bound'][1]}){extra}")
    return res


def _time_direct(torch, g):
    """The direct kernels at the M2-BERT path's shape (B=128, H=768, L=128,
    N=256, bf16, ungated), and the Monarch kernels beside them at that shape
    and at N=512, L=256. Both routes compute one function, so their rows
    share one bound: its inputs read once and its outputs written once,
    against the f32 operations the function needs with FFTs, counted as in
    phase_timing. The direct kernels' dense transforms (M = N/2; 2 L M
    operations a row a transform, the folded half-spectrum DFT and inverse)
    are the design's own work, reported apart as design_ops_ms."""
    from flashfftconv_tpu_torch.ops import monarch, monarch_cuda
    from flashfftconv_tpu_torch.ops.plan import make_plan

    dev = torch.device("cuda")
    res = {}
    with torch.inference_mode():
        for n in (BERT_N_FFT, 2 * BERT_N_FFT):
            plan = make_plan(n, torch.bfloat16, device=dev)
            b, h, length, m, ns = BERT_B, BERT_D_MODEL, n // 2, n // 2, plan.n_stages
            t = torch.arange(n, dtype=torch.float32)
            k = (torch.randn(h, n, generator=g) * 0.02 * torch.exp(-t / 50)).to(dev)
            u, dout = ((torch.randn(b, h, length, generator=g) * 0.02).to(dev, torch.bfloat16)
                       for _ in "ab")
            k_f = monarch_cuda.spectrum(plan, k)
            rows, io, spec = b * h, u.numel() * 2, k_f.numel() * 8
            fwd_ops = rows * (2 * _fft_flops(m, ns) + 40 * (m // 2) + 4 * length)
            bwd_ops = rows * (3 * _fft_flops(m, ns) + 60 * (m // 2) + 4 * length + 2 * (m + 1))
            # the main path's rows keep the kernels' names; the others carry N
            sfx = "" if n == BERT_N_FFT else f"@{n}"

            def fft_conv():
                return torch.fft.irfft(torch.fft.rfft(u.float(), n=n) * k_f, n=n)[
                    ..., :length].to(u.dtype)

            def fft_bwd():
                g_f, u_f = torch.fft.rfft(dout.float(), n=n), torch.fft.rfft(u.float(), n=n)
                du = torch.fft.irfft(g_f * k_f.conj(), n=n)[..., :length].to(u.dtype)
                return du, (g_f * u_f.conj()).sum(0)

            # direct_conv: u and k_f in, y out; the kernel runs two dense
            # transforms a row and the pointwise product
            res["direct_conv" + sfx] = dict(
                ms=_time_ms(torch, lambda: monarch_cuda.direct_conv(plan, u, k_f)),
                plain_ms=_time_ms(torch, lambda: monarch.direct_conv_plain(plan, u, k_f), iters=5),
                library_ms=_time_ms(torch, fft_conv),
                bound=_bound(2 * io + spec, fwd_ops),
                design_ops_ms=rows * (4 * length * m + 16 * m) / F32_FLOPS * 1e3,
            )
            # direct_conv_bwd: u, dout and k_f in, du and one dk spectrum out;
            # the kernel runs three dense transforms a row and the dk products
            res["direct_conv_bwd" + sfx] = dict(
                ms=_time_ms(torch, lambda: monarch_cuda.direct_conv_bwd(plan, u, k_f, None, None,
                                                                        dout)),
                plain_ms=_time_ms(torch, lambda: monarch.direct_conv_bwd_plain(
                    plan, u, k_f, None, None, dout), iters=5),
                library_ms=_time_ms(torch, fft_bwd),
                bound=_bound(3 * io + 2 * spec, bwd_ops),
                design_ops_ms=rows * (6 * length * m + 30 * m) / F32_FLOPS * 1e3,
            )
            res[f"monarch_conv@{n}"] = dict(
                ms=_time_ms(torch, lambda: monarch_cuda.monarch_conv(plan, u, k_f)),
                plain_ms=_time_ms(torch, lambda: monarch.conv_with_spectrum(plan, u, k_f), iters=5),
                library_ms=_time_ms(torch, fft_conv),
                bound=_bound(2 * io + spec, fwd_ops),
            )
            res[f"monarch_conv_bwd@{n}"] = dict(
                ms=_time_ms(torch, lambda: monarch_cuda.monarch_conv_bwd(plan, u, k_f, None, None,
                                                                          dout)),
                plain_ms=_time_ms(torch, lambda: monarch.conv_bwd_plain(plan, u, k_f, None, None,
                                                                        dout), iters=5),
                library_ms=_time_ms(torch, fft_bwd),
                bound=_bound(3 * io + 2 * spec, bwd_ops),
            )
            if n == BERT_N_FFT:
                # The whole direct backward of one conv as FftConvFunction runs
                # it: spectrum of the taps, direct_conv_bwd, dk_finish; u, dout
                # and the taps in, du and f32 dk out; beside the five torch.fft
                # calls of the same function.
                def direct_bwd():
                    kf = monarch_cuda.spectrum(plan, k)
                    du, _, _, parts = monarch_cuda.direct_conv_bwd(plan, u, kf, None, None, dout)
                    return du, monarch_cuda.dk_finish(plan, parts, n)

                def plain_bwd():
                    kf = monarch.kernel_spectrum(plan, k)
                    du, _, _, parts = monarch.direct_conv_bwd_plain(plan, u, kf, None, None, dout)
                    return du, monarch.dk_finish_plain(plan, parts, n)

                def fft_whole_bwd():
                    kf = torch.fft.rfft(k, n=n)
                    g_f = torch.fft.rfft(dout.float(), n=n)
                    du = torch.fft.irfft(g_f * kf.conj(), n=n)[..., :length].to(u.dtype)
                    g_f = g_f * torch.fft.rfft(u.float(), n=n).conj()
                    return du, torch.fft.irfft(g_f.sum(0), n=n)

                res["direct_bwd_chain"] = dict(
                    ms=_time_ms(torch, direct_bwd),
                    plain_ms=_time_ms(torch, plain_bwd, iters=5),
                    library_ms=_time_ms(torch, fft_whole_bwd),
                    bound=_bound(3 * io + 2 * k.numel() * 4,
                                 bwd_ops + 2 * h * (_fft_flops(m, ns) + 20 * (m // 2))),
                    design_ops_ms=rows * (6 * length * m + 30 * m) / F32_FLOPS * 1e3,
                )
            del u, dout, k, k_f
    torch.cuda.empty_cache()
    return res


def _time_long(torch, g):
    """The long kernels at the dna path's shapes (B=1, H=256, L=2^20, N=2^21,
    bf16, ungated). Bounds count what each function needs: its inputs read
    once and its outputs written once, against its f32 operations (radix-2
    line DFTs at 5 n log2 n, 6 a point for each twiddle, 20 a point for the
    split and unsplit, 6 for the product). The complex64 bands that only
    this design moves through device memory are reported as overhead_ms."""
    from flashfftconv_tpu_torch.ops import monarch, monarch_cuda
    from flashfftconv_tpu_torch.ops.plan import make_plan

    dev = torch.device("cuda")
    plan = make_plan(DNA_N_FFT, torch.bfloat16, device=dev)
    k, u = _long_inputs(torch, g, dev)
    m, h, length = plan.inner, DNA_D_MODEL, DNA_L_MAX
    lf, lr = math.log2(plan.outer), math.log2(plan.band)
    outer_flops = h * m * (5 * lf + 6 * plan.n_outer)  # outer DFT, its twiddles
    band_flops = h * m * (5 * lr + 6 * (len(plan.sub.factors) - 1))  # one band FFT a point
    bands_bytes = h * m * 8
    res = {}
    with torch.inference_mode():
        k_f = monarch_cuda.long_spectrum(plan, k)
        z = monarch_cuda.butterfly(plan, u)
        fwd = lambda: monarch_cuda.butterfly(plan, u)
        inv = lambda: monarch_cuda.butterfly(plan, z, inverse=True, length=length, dtype=u.dtype)
        # butterfly, either direction: the reals on one side, the bands on the other
        res["butterfly"] = dict(
            ms=_time_ms(torch, fwd, iters=10),
            inverse_ms=_time_ms(torch, inv, iters=10),
            plain_ms=_time_ms(torch, lambda: monarch.butterfly_plain(plan, u), iters=2, warmup=1),
            library_ms=None,
            bound=_bound(u.numel() * 2 + bands_bytes, outer_flops),
        )
        # the band kernel: bands in and out, k_f in; two band FFTs a point
        res["long_conv"] = dict(
            ms=_time_ms(torch, lambda: monarch_cuda.long_conv_inner(plan, z, k_f), iters=10),
            plain_ms=_time_ms(torch, lambda: monarch.long_conv_inner_plain(plan, z, k_f),
                              iters=2, warmup=1),
            library_ms=None,
            bound=_bound(2 * bands_bytes + k_f.numel() * 8, 2 * band_flops + h * m * 26),
        )
        del z
        # long_conv as a whole: u and k_f in, y out; the bands cross device
        # memory four times (written and read on each side of the band kernel)
        conv_flops = 2 * (outer_flops + band_flops) + h * m * 26

        def fft_conv():
            return torch.fft.irfft(torch.fft.rfft(u.float(), n=DNA_N_FFT) * k_f,
                                   n=DNA_N_FFT)[..., :length].to(u.dtype)

        res["long_conv_chain"] = dict(
            ms=_time_ms(torch, lambda: monarch_cuda.long_conv(plan, u, k_f), iters=10),
            plain_ms=_time_ms(torch, lambda: monarch.conv_with_spectrum(plan, u, k_f), iters=2,
                              warmup=1),
            library_ms=_time_ms(torch, fft_conv, iters=5),
            bound=_bound(u.numel() * 2 * 2 + k_f.numel() * 8, conv_flops),
            overhead_ms=4 * bands_bytes / HBM_BYTES_PER_S * 1e3,
        )
        # long_spectrum: f32 taps in, half spectrum out; the bands cross twice
        res["long_spectrum"] = dict(
            ms=_time_ms(torch, lambda: monarch_cuda.long_spectrum(plan, k), iters=10),
            plain_ms=_time_ms(torch, lambda: monarch.long_spectrum_plain(plan, k), iters=2,
                              warmup=1),
            library_ms=_time_ms(torch, lambda: torch.fft.rfft(k, n=DNA_N_FFT), iters=5),
            bound=_bound(k.numel() * 4 + k_f.numel() * 8, outer_flops + band_flops + h * m * 10),
            overhead_ms=2 * bands_bytes / HBM_BYTES_PER_S * 1e3,
        )
        # The band kernel of the long backward (ungated, as on the main
        # path): both band arrays and k_f in, du's bands and one dk spectrum
        # out (at B = 1 the partials are that spectrum); three band FFTs a
        # point, two splits, one unsplit and two products a frequency.
        dout = torch.randn(u.shape, generator=torch.Generator(device=dev).manual_seed(1),
                           device=dev).to(u.dtype)
        zu, zg = monarch_cuda.butterfly(plan, u), monarch_cuda.butterfly(plan, dout)
        spec_bytes = k_f.numel() * 8
        res["long_conv_bwd"] = dict(
            ms=_time_ms(torch, lambda: monarch_cuda.long_conv_bwd_inner(plan, zu, zg, k_f),
                        iters=10),
            plain_ms=_time_ms(torch, lambda: monarch.long_conv_bwd_inner_plain(plan, zu, zg, k_f),
                              iters=1, warmup=1),
            library_ms=None,
            bound=_bound(3 * bands_bytes + 2 * spec_bytes, 3 * band_flops + h * m * 42),
        )
        parts = monarch_cuda.long_conv_bwd_inner(plan, zu, zg, k_f)[2]
        del zu, zg
        # long_dk_finish: one dk spectrum in, f32 dk out; the unsplit, one
        # band FFT and the outer stage a point. The dk bands between its band
        # kernel and the inverse butterfly are the design's own traffic.
        res["long_dk_finish"] = dict(
            ms=_time_ms(torch, lambda: monarch_cuda.long_dk_finish(plan, parts, length), iters=10),
            plain_ms=_time_ms(torch, lambda: monarch.long_dk_finish_plain(plan, parts, length),
                              iters=1, warmup=1),
            library_ms=_time_ms(torch, lambda: torch.fft.irfft(parts.sum(0), n=DNA_N_FFT)[
                ..., :length], iters=5),
            bound=_bound(spec_bytes + h * length * 4, outer_flops + band_flops + h * m * 10),
            overhead_ms=2 * bands_bytes / HBM_BYTES_PER_S * 1e3,
        )
        del parts
        # The whole long backward of one conv as FftConvFunction runs it: u,
        # dout and the f32 taps in, du and f32 dk out; five M-point FFTs a
        # row. Bands, k_f and the dk spectrum cross device memory 14 times
        # between the kernels (written and read: the taps' bands, k_f, the
        # bands of u and of dout, du's bands, P, dk's bands).
        def long_bwd():
            kf = monarch_cuda.long_spectrum(plan, k)
            du, _, _, parts = monarch_cuda.long_conv_bwd(plan, u, kf, None, None, dout)
            return du, monarch_cuda.long_dk_finish(plan, parts, length)

        def plain_bwd():
            kf = monarch.long_spectrum_plain(plan, k)
            du, _, _, parts = monarch.conv_bwd_plain(plan, u, kf, None, None, dout)
            return du, monarch.dk_finish_plain(plan, parts, length)

        def fft_bwd():
            kf = torch.fft.rfft(k, n=DNA_N_FFT)
            g_f = torch.fft.rfft(dout.float(), n=DNA_N_FFT)
            du = torch.fft.irfft(g_f * kf.conj(), n=DNA_N_FFT)[..., :length].to(u.dtype)
            del kf
            g_f = g_f * torch.fft.rfft(u.float(), n=DNA_N_FFT).conj()
            return du, torch.fft.irfft(g_f.sum(0), n=DNA_N_FFT)[..., :length]

        del k_f
        res["long_bwd_chain"] = dict(
            ms=_time_ms(torch, long_bwd, iters=5, warmup=1),
            plain_ms=_time_ms(torch, plain_bwd, iters=1, warmup=1),
            library_ms=_time_ms(torch, fft_bwd, iters=5, warmup=1),
            bound=_bound(u.numel() * 2 * 3 + k.numel() * 4 * 2,
                         5 * (outer_flops + band_flops) + h * m * 62),
            overhead_ms=14 * bands_bytes / HBM_BYTES_PER_S * 1e3,
        )
    log(f"timing butterfly inverse: {res['butterfly']['inverse_ms']:.4f} ms (the row's ms is "
        "the forward's)")
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--out-dir", default="", help="write all numbers to DIR/chip_smoke.json")
    args = ap.parse_args()
    phases = args.phases.split(",")
    if unknown := set(phases) - set(PHASES) - set(OPT_IN_PHASES):
        ap.error(f"unknown phases {sorted(unknown)}")

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a GPU",
              file=sys.stderr)
        return 2
    if not (HERE / "flashfftconv_tpu_torch" / "__init__.py").exists():
        print(f"chip_smoke: no flashfftconv_tpu_torch package beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import flashfftconv_tpu_torch as ff

    if Path(ff.__file__).resolve().parent != HERE / "flashfftconv_tpu_torch":
        print(f"chip_smoke: imported the package from {ff.__file__}, not from {HERE}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(args.seed)

    results = {}
    identity = phase_identity(torch)
    results["identity"] = identity
    if "build" in phases:
        results["build"] = phase_build()
    if "kernels" in phases:
        results["kernels"] = phase_kernels(torch, g)
    if "serve" in phases:
        results["serve"] = phase_serve(torch, args.seed, np)
    if "train" in phases:
        results["train"] = phase_train(torch, args.seed, np)
    if "parity" in phases:
        results["parity"] = phase_parity(torch, args.seed)
    if "grad_parity" in phases:
        results["grad_parity"] = phase_grad_parity(torch, args.seed)
    if "dna" in phases:
        results["dna"] = phase_dna(torch, args.seed, np)
    if "dna_train" in phases:
        results["dna_train"] = phase_dna_train(torch, args.seed, np)
    if "long_parity" in phases:
        results["long_parity"] = phase_long_parity(torch, args.seed, np)
    if "bert" in phases:
        results["bert"] = phase_bert(torch, args.seed, np)
    if "bert_train" in phases:
        results["bert_train"] = phase_bert_train(torch, args.seed, np)
    if "bert_parity" in phases:
        results["bert_parity"] = phase_bert_parity(torch, args.seed, np)
    if "timing" in phases:
        results["timing"] = phase_timing(torch, g)
    if "profile" in phases:
        results["profile"] = phase_profile(torch, args.seed)

    results["versions"] = {"python": sys.version.split()[0], "torch": torch.__version__,
                           "cuda": torch.version.cuda}
    if args.out_dir:
        out_dir = Path(args.out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "chip_smoke.json").write_text(json.dumps(results, indent=1, default=str))

    if JSON_PHASES <= set(phases):
        rows = []
        for name, meta in KERNELS.items():
            t = results["timing"][name]
            path = LAUNCH_PHASE.get(name, "train")
            rows.append({
                "name": name, "route": "cuda", **meta,
                "launches": results[path]["launches"][name],
                "max_abs_err": results["kernels"][name],
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
                "library_ms": t["library_ms"],
            })
        print(json.dumps({"kernels": rows}))
    print(identity["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": identity["device"],
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
