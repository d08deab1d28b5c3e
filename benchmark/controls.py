"""The readings a cell's limits are set from, apart from the sound runs'
own: the control, the faults and the error of the counted events.

    python3 benchmark/controls.py --workload <name> --seeds 11,12,13 [--what control,faults,counts]

One JSON line a reading, on the card at the cell's own size:

- ``control`` and ``faults``: what the cell's loop reads
  (``loops/<loop>.py``, ``controls``): the reference put in the program's
  place, computed in bfloat16 (the nearest precision below the
  configuration's float32), or with a fault planted, judged by the cell's
  numbers against the float32 reference;
- ``counts``: the kernel's events as the benchmark counts them (a
  sixteenth of the rows, scaled) against the program's own counting
  instantiation (``counts/<kernel>.py``, ``program_events``) over the
  whole frame, at the inputs the loop's ``count_at`` names.

The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def _args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--what", default="control,faults,counts")
    return p.parse_args(argv)


def counts_reading(cell, seed: int, device) -> dict:
    """The benchmark's count of the kernel's events against the program's."""
    import torch

    from harness import window
    from reference import tracer

    cfg = cell.config
    H, W, spp, B = cfg["height"], cfg["width"], cfg["spp"], cfg["max_bounces"]
    counts = cell.counts(cell.traffic["kernel"])
    at = cell.loop().count_at(cell, seed)
    run = window.Run(cell, seed, 0.0, False, device, 0.0)
    scene, camera = window.port_inputs(run, at["tables"], at["camera"])
    with torch.no_grad():
        mine, share = tracer.count_events(counts.RENDER, tracer.tensors(at["tables"], device),
                                          tracer.camera_tensors(at["camera"], device),
                                          H, W, spp, B, at["seed"], at["jitter"])
        port = counts.program_events(scene, camera, H, W, spp, B, at["seed"], at["jitter"])
    return {"reading": "counts", "share_counted": share, "benchmark": mine, "program": port,
            "relative_error": {k: mine[k] / port[k] - 1.0 if port[k] else 0.0 for k in port}}


def main(argv=None) -> int:
    args = _args(argv)
    for p in (str(ROOT), str(BENCH)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from harness import spec

    if not torch.cuda.is_available():
        print("controls.py: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload, ROOT)
    device = torch.device("cuda", 0)
    what = set(args.what.split(","))
    for seed in (int(s) for s in args.seeds.split(",")):
        readings = cell.loop().controls(cell, seed, device, what)
        if "counts" in what:
            readings.append(counts_reading(cell, seed, device))
        for r in readings:
            print(json.dumps({"workload": cell.name, "seed": seed, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
