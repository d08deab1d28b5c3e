"""Run one cell of the port's benchmark once, on the card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. ``BENCHMARK.json`` names the cells; each
cell's configuration, traffic mix, per-layer metrics and kernel counts are
files of their own under this folder (``harness/spec.py``). The run builds
its inputs from ``--seed``, warms up, measures whole units of work for
``--seconds`` seconds, checks what they produced against the plain
reference (``reference/``), and prints the result as the last line of its
standard output: the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics read from a ``torch.profiler`` trace. The numbers
compared for ``correct`` and their limits are its last lines on standard
error and the result's last key, ``checks``.

Without a CUDA device (or with fewer than the cell asks for) it exits with
2 and prints no result; so it does where ``sys.modules`` holds JAX or the
JAX package once the window has closed (exit 3).
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    if args.seed < 0:
        print(f"--seed {args.seed}: a seed is a whole number >= 0", file=sys.stderr)
        return 2
    # Every build and kernel cache in the checkout, at a fixed path: the
    # port builds its kernels into build/kernels beside its package.
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    for p in (str(ROOT), str(BENCH)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from harness import spec

    cell = spec.cell(args.workload, ROOT)
    import torch

    marks = {"torch": time.perf_counter() - T0}

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, {have} found",
              file=sys.stderr)
        return 2
    from harness import core, window

    import path_tracer_c_tpu_torch  # noqa: F401  the program; a checkout without it stops here

    torch.set_num_threads(4)
    device = torch.device("cuda", 0)
    torch.empty(1, device=device)  # the CUDA context
    run = window.Run(cell, args.seed, args.seconds, bool(args.trace), device, T0, marks)
    run.mark("context")
    result = core.run_cell(run)
    bad = core.forbidden_modules()
    if bad:
        print(f"JAX loaded in the benchmark's process: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
