#!/usr/bin/env python3
"""Tile sweep of the hand render kernels on one GPU: the counterpart of
``scripts/tile_sweep.py`` (the Pallas kernels' tiles on a TPU).

    python3 scripts/torch_tile_sweep.py [fwd|bwd|both|phys|phys_fused|phys_bwd|all]
                                        [THxTW[/WHxWW] ...] [--shapes headline|defaults]
                                        [--tree DIR] [--label NAME]
    python3 scripts/torch_tile_sweep.py --code [--tree DIR]
    python3 scripts/torch_tile_sweep.py --code-against DIR
    python3 scripts/torch_tile_sweep.py --summarize RUN.jsonl ...

The first argument takes the JAX script's modes (``fwd``: B1; ``bwd``, its
reference tier's backward: B2, whose Jacobian the port contracts; ``both``)
and the port's other kernels (``phys``: B3, ``phys_fused``: B4,
``phys_bwd``: B5, ``all``: the five). Points are written ``THxTW/WHxWW``
(``path_tracer_c_tpu_torch/ops/render_kernel.py`` ``TILES``), or ``THxTW``
as the JAX script writes a tile, for the first point of that tile; without
them every point of each kernel is timed. One line a point (utils/tile_sweep.py
``sweep``): the kernel, the point, the shape, Grays/s, the median ms of 3 by
CUDA events as called, the ms of the kernel alone on operands packed once,
ptxas's registers and spills; then a JSON line of all of them with the
card's name and power limit.

``--shapes headline`` (the default) times glossy at 1024x1024 and 8
bounces, B1 and B3 at 64 spp and the gradient kernels at 16 spp;
``--shapes defaults`` at each shape of ``DEFAULT_SHAPES``. ``--tree`` imports
another checkout's package (``git archive`` of a parent unpacked under
``build/``) in place of this one; a checkout from before the tile is timed
at its one launch shape. Run parent, this, this, parent in one chip call to
compare.

``--code`` prints, for the timed library, each instantiation's ptxas
registers, stack and spills and its SASS loads and stores (the default
tile taken out of its name); ``--code-against DIR`` prints both trees' and
every difference, and exits non-zero where they differ.

``--summarize`` reads the JSON lines of earlier runs (parent, this, this,
parent at ``--shapes defaults``) and prints the defaults' verdict
(utils/tile_sweep.py ``summarize``): each point's times by kernel, shape and
timing (alone, as called), the default's spread over every run, where a
point won by more than it, and the points that won alone at every shape
(and as called). It runs nothing.

Otherwise, without a CUDA device it exits non-zero, naming the missing
device: the sweep never runs on the CPU.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
MODES = ("fwd", "bwd", "both", "phys", "phys_fused", "phys_bwd", "all")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", nargs="?", default="both", choices=MODES)
    ap.add_argument("points", nargs="*", help="THxTW[/WHxWW]: only these points")
    ap.add_argument("--shapes", choices=("headline", "defaults"), default="headline")
    ap.add_argument("--tree", default=str(REPO))
    ap.add_argument("--label", default="this")
    ap.add_argument("--code", action="store_true")
    ap.add_argument("--code-against", metavar="DIR")
    ap.add_argument("--summarize", nargs="+", metavar="RUN")
    return ap.parse_args(argv)


def load_sweep(tree: str):
    """This checkout's ``utils/tile_sweep.py``, over the package of
    ``tree``."""
    sys.path.insert(0, str(Path(tree).resolve()))
    spec = importlib.util.spec_from_file_location(
        "tile_sweep", REPO / "path_tracer_c_tpu_torch" / "utils" / "tile_sweep.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.summarize:
        ts = load_sweep(args.tree)
        runs = [json.loads(line) for path in args.summarize
                for line in Path(path).read_text().splitlines() if line.startswith("{")]
        print(json.dumps(ts.summarize(runs)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_tile_sweep: no CUDA device (torch.cuda.is_available() is "
                         "False); the sweep runs on the card only")
    ts = load_sweep(args.tree)
    from path_tracer_c_tpu_torch.utils.profiling import card_line

    dev = torch.device("cuda", 0)
    card = card_line(dev)
    if args.code:
        print(json.dumps({"label": args.label, "tree": args.tree, "card": card,
                          "code": ts.code_report()}), flush=True)
        return 0
    if args.code_against:
        mine = ts.code_report()
        cmd = [sys.executable, str(Path(__file__).resolve()), "--code", "--tree",
               args.code_against, "--label", "against"]
        other = json.loads(subprocess.run(cmd, capture_output=True, text=True, check=True,
                                          timeout=1800).stdout.strip().splitlines()[-1])["code"]
        diff = {k: {"this": mine.get(k), "against": other.get(k)}
                for k in sorted(set(mine) | set(other)) if mine.get(k) != other.get(k)}
        print(json.dumps({"card": card, "instantiations": len(mine), "against": args.code_against,
                          "equal": not diff, "differences": diff}), flush=True)
        return 0 if not diff else 1
    kinds = ts.GROUPS[args.mode]
    chosen = ts.parse_points(args.points) if args.points else None
    shapes = tuple(ts.DEFAULT_SHAPES) if args.shapes == "defaults" else None
    print(f"{args.label} [{card}]", flush=True)
    records = ts.sweep(kinds, dev, chosen, shapes,
                       log=lambda line: print(f"{args.label}: {line}", flush=True))
    print(json.dumps({"label": args.label, "tree": args.tree, "card": card,
                      "sweep": records}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
