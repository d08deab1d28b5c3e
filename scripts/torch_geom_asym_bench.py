#!/usr/bin/env python3
"""The geometry gradient's cost, fused against eager, at one shape on one
scene: the PyTorch port's counterpart of ``scripts/geom_asym_bench.py``.

Runs ``path_tracer_c_tpu_torch.utils.geom_asym.geom_asym``: the gradient of
a pixel loss with respect to every floating-point leaf of the glossy scene
through the fused physical kernel B4 with its emitter-geometry planes
(``csrc/render_phys_fused.cu``) and through autograd over the eager
physical tier, at 256x256, 16 spp, 4 bounces; the fused gradient on the
glossy scene with a triangle quad lamp (``tri_nee``) at 1024x1024, 64 spp,
8 bounces; and both sides on glossy at that headline shape, each with its
peak device memory. Each time is the median of 3 calls by CUDA events after
a warm-up call; each side's time goes to standard error as it is taken.
Prints one JSON line with the JAX script's keys, then the
pair's (``pair_*``), the peaks and the card's name and power limit. From
the repository root:

    python3 scripts/torch_geom_asym_bench.py [--small] [--cpu]

``--small`` runs the triangle-lit scene and the pair at 256x256, 8 spp, 4
bounces (the JAX script's shape off the TPU); ``--cpu`` runs those shapes on
the CPU through the plain twins. No other option shrinks a shape. Without
``--cpu`` it needs a CUDA device and the CUDA toolkit, and raises without a
device.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--small", action="store_true",
                    help="the triangle-lit scene and the pair at 256x256, 8 spp, 4 bounces")
    ap.add_argument("--cpu", action="store_true", help="the small shapes, on the CPU")
    args = ap.parse_args(argv)
    from path_tracer_c_tpu_torch.utils import geom_asym as ga
    from path_tracer_c_tpu_torch.utils.profiling import bench_device

    device = bench_device(args.cpu, "torch_geom_asym_bench")
    big = ga.SMALL_HEADLINE if args.small or args.cpu else ga.HEADLINE
    t0 = time.perf_counter()
    log = lambda msg: print(f"[geom_asym +{time.perf_counter() - t0:.0f}s] {msg}",
                            file=sys.stderr, flush=True)
    print(json.dumps(ga.geom_asym(device, ga.SHAPE, big, big, log=log)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
