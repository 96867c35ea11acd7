"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload hyena-125m.train --seed 7 --seconds 30 --trace 0

Run from the root of a checkout of the repository. Needs a CUDA device
(``torch.cuda.is_available()``) and at least as many as the cell asks for;
without them it exits with code 2 and prints no result. The last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or its per-layer
metrics with ``--trace 1``), ``device`` and, traced, ``breakdown``; the
numbers of the output check come last, under ``checks``, and again as the
last lines of standard error. The run fails, with no result, if a module of
JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = ROOT / "portbench" / ".cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(cache / "inductor"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(cache / "nv"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", required=True, type=int)
    p.add_argument("--seconds", required=True, type=float)
    p.add_argument("--trace", default=0, type=int, choices=(0, 1))
    args = p.parse_args(argv)
    _caches()
    # the repository's root, not this directory, so that portbench's module
    # names (trace, data) do not shadow others
    sys.path[:] = [str(ROOT)] + [q for q in sys.path if Path(q or '.').resolve() != ROOT / 'portbench']
    import torch

    from portbench import harness

    bench = harness.benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        harness.log(f"unknown workload {args.workload!r}; have {sorted(cells)}")
        return 2
    need = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        harness.log(f"needs {need} CUDA device(s); torch sees "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    seed = abs(args.seed)
    result = harness.run(args.workload, seed, args.seconds, bool(args.trace),
                         t_process=T_PROCESS)
    loaded = harness.forbidden_modules()
    if loaded:
        harness.log(f"JAX or the JAX package was loaded: {loaded[:20]}")
        return 3
    for name, c in result["checks"].items():
        harness.log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
