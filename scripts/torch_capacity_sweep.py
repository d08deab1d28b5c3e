#!/usr/bin/env python3
"""Throughput of the forward kernels against scene capacity, across the
shared-table budget: the PyTorch port's counterpart of
``scripts/capacity_sweep.py``.

Runs ``path_tracer_c_tpu_torch.utils.capacity_sweep.sweep``: B1
(``csrc/render_fwd.cu``) and B3 (``csrc/render_phys.cu``) as called, against
sphere count (four materials) and material count (sixteen spheres) at 5,
15, 64, 200, 1024, 1536 and 2048, at 512x512, 16 spp, 4 bounces, each time
the median of 3 calls by CUDA events after a warm-up call. Prints one JSON
line a point with the JAX script's keys, then each kernel's table bytes and
placement (shared or global memory), its time alone on operands packed
once, where the tables fit the time of its ``global_tables`` instantiation
as called and alone, and the card's name and power limit. From the repository root:

    python3 scripts/torch_capacity_sweep.py [--small] [--cpu]

``--small`` runs 64x64, 1 spp, 2 bounces (the JAX script's shape off the
TPU); ``--cpu`` runs that shape once on the CPU through the kernels' plain
twins, with no instantiation and no packed launch. No other option shrinks
the shape. Without ``--cpu`` it needs a CUDA device and the CUDA toolkit
(the kernels are built on first use into build/kernels/), and raises
without a device.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--small", action="store_true", help="64x64, 1 spp, 2 bounces")
    ap.add_argument("--cpu", action="store_true", help="the small shape once, on the CPU")
    args = ap.parse_args(argv)
    from path_tracer_c_tpu_torch.utils import capacity_sweep as cs
    from path_tracer_c_tpu_torch.utils.profiling import bench_device

    device = bench_device(args.cpu, "torch_capacity_sweep")
    shape = cs.SMALL_SHAPE if args.small or args.cpu else cs.SHAPE
    for line in cs.sweep(device, shape, reps=1 if args.cpu else 3):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
