#!/usr/bin/env python3
"""Scaling harness, rays/s against mesh size: the PyTorch port's
counterpart of ``scripts/scaling_bench.py``.

Renders the glossy scene at 1024x1024, 64 spp, 8 bounces through
``parallel.render_sharded`` on ``tile x spp`` meshes over the first 1, 2,
4, ... devices (``path_tracer_c_tpu_torch.parallel.scaling``), each time
the median of 3 renders by CUDA events after a warm-up render, and prints
one JSON line a mesh: ``devices``, ``mesh``, ``rays_per_sec``, ``seconds``,
``efficiency`` against the one-device point, then the engine, shape, device
list, ``repeated`` (a device named more than once: the efficiency then
measures the parallel layer's cost, not scaling) and the card's name and
power limit. From the repository root:

    python3 scripts/torch_scaling_bench.py [--small] [--engine E] [--spp-axis N]
                                           [--devices LIST] [--cpu]

``--devices`` defaults to every visible card; a comma-separated list such
as ``cuda:0,cuda:0,cuda:0,cuda:0`` repeats one. ``--cpu`` lays eight CPU
slots (the JAX rehearsal's eight fake CPU devices), or as many as a list of
``cpu`` names, and runs the small shape. ``--small`` runs 256x256, 8 spp, 4
bounces; no other option shrinks the shape. Without ``--cpu`` it needs a
CUDA device, and raises without one.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    from path_tracer_c_tpu_torch.parallel import scaling as sc

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--small", action="store_true", help="256x256, 8 spp, 4 bounces")
    ap.add_argument("--engine", default="pallas", choices=sc.ENGINES)
    ap.add_argument("--spp-axis", type=int, default=1,
                    help="devices on the spp axis (the rest go to tile)")
    ap.add_argument("--devices", default=None,
                    help="comma-separated devices (default: every visible card)")
    ap.add_argument("--cpu", action="store_true", help="CPU slots, the small shape")
    args = ap.parse_args(argv)
    import torch

    from path_tracer_c_tpu_torch.utils.profiling import bench_device

    bench_device(args.cpu, "torch_scaling_bench")
    if args.devices is not None:
        devices = [torch.device(d) for d in args.devices.split(",")]
    elif args.cpu:
        devices = [torch.device("cpu")] * 8
    else:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if any((d.type == "cpu") != args.cpu for d in devices):
        raise SystemExit("torch_scaling_bench: --devices must name CPU slots with --cpu "
                         "and cards without it")
    shape = sc.SMALL_SHAPE if args.small or args.cpu else sc.SHAPE
    for line, _ in sc.scaling(devices, shape, args.engine, args.spp_axis):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
