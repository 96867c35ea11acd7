#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (flashfftconv_tpu_torch) on one GPU.

Run from the root of a checkout on a machine with an H100:

    python3 chip_smoke.py [--seed 0] [--out-dir DIR]
                          [--phases build,identity,kernels,serve,parity,timing[,profile]]

Phases, each of which fails the run by raising:
  build     builds every CUDA kernel from csrc/ with nvcc (one nvcc per
            source, started together) and prints ptxas's register report;
  identity  prints the card's name and power limit;
  kernels   holds each kernel against its plain PyTorch version on the card,
            at the main path's shapes and at gated, padded, odd-batch and
            ragged-channel shapes, with the tolerance printed;
  serve     builds Hyena-125M (12 layers, d_model 768, l_max 8192, vocab
            50257, bf16, random weights from --seed) and answers 4 requests
            (prompts of 512..4096 tokens, 8 new tokens each, greedy) through
            utils.generation.generate, after one scoring forward; checks the
            logits are finite and that every kernel launched 12 times a forward;
  parity    a 2-layer, d_model 128, l_max 1024 Hyena LM in f32 with the same
            weights on the card (kernels) and on the CPU (plain versions):
            logits agree within 2e-3;
  timing    times each kernel, its plain version and a one-call PyTorch
            yardstick with CUDA events at the main path's shapes;
  profile   (only when named in --phases) traces one Hyena-125M forward
            with torch.profiler: device time by kernel and by kind, and the
            device's busy share of the forward's wall time.

Prints the card's name and power limit (nvidia-smi) and one JSON line of
kernels, then, as the last line, {"ok": true, "device": {...}}. Exits non-zero
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
PHASES = ("build", "identity", "kernels", "serve", "parity", "timing")
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
}


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
    return errs


def _counters():
    from flashfftconv_tpu_torch.ops import depthwise as dw
    from flashfftconv_tpu_torch.ops import monarch_cuda

    return {"spectrum": monarch_cuda.spectrum, "monarch_conv": monarch_cuda.monarch_conv,
            "depthwise": dw.depthwise}


def phase_serve(torch, seed, np):
    from flashfftconv_tpu_torch.models.lm import ConvLMHeadModel
    from flashfftconv_tpu_torch.utils.generation import generate

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    model = ConvLMHeadModel(
        d_model=D_MODEL, n_layer=N_LAYER, d_inner=4 * D_MODEL, vocab_size=VOCAB, l_max=L_MAX,
        dtype=torch.bfloat16, device=dev, generator=torch.Generator().manual_seed(seed),
    ).eval()
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


def _kind(name: str) -> str:
    for kind, keys in (
        ("monarch_conv", ("monarch_conv_kernel",)),
        ("spectrum", ("spectrum_kernel",)),
        ("depthwise", ("depthwise_",)),
        ("matmul", ("gemm", "cutlass", "xmma", "cublas", "nvjet", "sm90_")),
        ("copy or cast", ("copy_kernel",)),
    ):
        if any(k in name for k in keys):
            return kind
    return "other"


def phase_profile(torch, seed):
    """Device time by kernel over one Hyena-125M serving forward."""
    from torch.profiler import ProfilerActivity, profile

    from flashfftconv_tpu_torch.models.lm import ConvLMHeadModel

    model = ConvLMHeadModel(
        d_model=D_MODEL, n_layer=N_LAYER, d_inner=4 * D_MODEL, vocab_size=VOCAB, l_max=L_MAX,
        dtype=torch.bfloat16, device="cuda", generator=torch.Generator().manual_seed(seed),
    ).eval()
    ids = torch.randint(0, VOCAB, (B, L_MAX), generator=torch.Generator().manual_seed(seed))
    ids = ids.cuda()
    with torch.inference_mode():
        model(ids)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model(ids)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
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
    log(f"profile: one forward, wall {wall_ms:.2f} ms (profiler on), device busy {busy:.2f} ms "
        f"({busy / wall_ms:.1%})")
    for kind, (t, n) in sorted(by_kind.items(), key=lambda kv: -kv[1][0]):
        log(f"  {kind}: {t:.3f} ms in {n} launches ({t / busy:.1%} of device time)")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    for name, (t, n) in top:
        log(f"    {t:8.3f} ms {n:4d}x {name[:110]}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "by_kind_ms": {k: v[0] for k, v in by_kind.items()},
            "top": [(name, t, n) for name, (t, n) in top]}


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
    for name, r in res.items():
        log(f"timing {name}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']:.4f} ms, bound {r['bound'][0]:.4f} ms ({r['bound'][1]})")
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
    if "parity" in phases:
        results["parity"] = phase_parity(torch, args.seed)
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

    if {"kernels", "serve", "timing"} <= set(phases):
        rows = []
        for name, meta in KERNELS.items():
            t = results["timing"][name]
            rows.append({
                "name": name, "route": "cuda", **meta,
                "launches": results["serve"]["launches"][name],
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
