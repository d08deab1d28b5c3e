#!/usr/bin/env python3
"""Decompose the PyTorch port's forward kernels' time against their speed of light.

Runs ``path_tracer_c_tpu_torch.utils.sol_decompose`` on one CUDA device at
the bench workload (glossy, 1024^2, 64 spp, 8 bounces; ``--small``: 256^2,
8 spp, 4 bounces) and prints two JSON lines, B1's and B3's (config 3's
jitter): the kernel's time, the per-class op rates kernel B6 measured, the
shares of the time taken by the counted operations, divergence, block start
and end (B7), table loads (B8) and the remainder, and the prices of its
policies (the kernel against its measurement instantiations), with the
card's name and power limit as nvidia-smi reports them.
``--per-sample`` prints two more lines: the same for B1's and B3's
measurement instantiation with the per-sample schedule (the kernels' body
before path regeneration, with their tables in shared memory).
``--fused`` prints two more lines: the same for the fused primal + Jacobian
kernels B2 and B4 (``fused_decompose``: besides, the per-bounce records,
the planes' read-modify-writes, B4's geometry adjoint), on the rates of
the first line. ``--bwd`` prints one more: the same for the two-pass oracle
B5 (``fused_decompose(kind="physical_bwd")``: the reduction, the geometry
adjoint, the records in shared memory, its other reductions, the counts of
its add sites). From the repository root:

    python3 scripts/torch_sol_decompose.py [--small] [--per-sample] [--fused] [--bwd]

Needs a CUDA device and the CUDA toolkit (the kernels are built on first
use into build/kernels/); exits non-zero without them.
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_sol_decompose: no CUDA device")
    from path_tracer_c_tpu_torch.utils.profiling import card_line
    from path_tracer_c_tpu_torch.utils.sol_decompose import fused_decompose, sol_decompose

    card = card_line("cuda")
    small = "--small" in sys.argv
    out = sol_decompose("cuda", small=small)
    print(json.dumps({**out, "card": card}), flush=True)
    rates = out["measured_rates"]
    phys = sol_decompose("cuda", small=small, rates=rates, kind="physical")
    print(json.dumps({**phys, "card": card}), flush=True)
    if "--per-sample" in sys.argv:
        for kind in ("forward", "physical"):
            d = sol_decompose("cuda", small=small, rates=rates, kind=kind, variant="per_sample")
            print(json.dumps({**d, "card": card}), flush=True)
    if "--fused" in sys.argv:
        for kind in ("fused", "physical_fused"):
            d = fused_decompose(kind, "cuda", small=small, rates=rates)
            print(json.dumps({**d, "card": card}), flush=True)
    if "--bwd" in sys.argv:
        d = fused_decompose("physical_bwd", "cuda", small=small, rates=rates)
        print(json.dumps({**d, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
