"""``BENCHMARK.json`` and the files it names, resolved for one cell.

Everything that belongs to one configuration, one traffic mix, one
per-layer metric or one kernel's counts sits in a file of its own, found
by its name:

- a configuration: the ``file`` its entry names (``configs/<name>.json``);
- a traffic mix: ``traffic/<name>.json``, the loop, the entry and their
  parameters;
- a loop: ``loops/<loop>.py``, whose ``run(run)`` drives the window,
  ``numbers(run, window)`` works out the numbers compared for ``correct``,
  ``count_at(cell, seed)`` names the inputs a kernel's events are counted
  at, and ``controls(cell, seed, device, what)`` reads the control;
- a per-layer metric: ``metrics/<name>.py``, whose ``read(ctx)`` returns
  the value or ``None`` where it finds nothing to read;
- a kernel's operation and byte counts: ``counts/<kernel>.py``, with the
  reference renderer that counts its events;
- a reference renderer: the ``module:function`` under ``reference/`` that
  the traffic mix or the counts name.

A cell is added by adding files and entries; nothing here names a cell,
a loop or a kernel.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def check_names(spec: dict) -> None:
    """Raise ``ValueError`` on a name or unit outside the allowed
    characters, or on two entries of one kind with one name."""
    named = [("config", c["name"]) for c in spec["configs"]]
    named += [("workload", w["name"]) for w in spec["workloads"]]
    named += [("workload config", w["config"]) for w in spec["workloads"]]
    named += [("traffic", w["traffic"]) for w in spec["workloads"]]
    named += [("metric", m["name"]) for m in spec["end_to_end"] + spec["per_layer"]]
    named += [("reduced key", k) for c in spec["configs"] for k in c["reduced"]]
    for what, name in named:
        if not NAME.match(name):
            raise ValueError(f"{what} name {name!r} is not a name")
    for m in spec["end_to_end"] + spec["per_layer"]:
        if not UNIT.match(m["unit"]):
            raise ValueError(f"metric {m['name']}: unit {m['unit']!r} is not a unit")
    for key, items in (("configs", spec["configs"]), ("workloads", spec["workloads"]),
                       ("metrics", spec["end_to_end"] + spec["per_layer"])):
        names = [i["name"] for i in items]
        if len(names) != len(set(names)):
            raise ValueError(f"two {key} share a name")


def load_module(path: Path, name: str):
    """A Python file of the benchmark as a module."""
    mod_spec = importlib.util.spec_from_file_location(name, path)
    if mod_spec is None or not path.is_file():
        raise FileNotFoundError(f"no module at {path}")
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


_MODULES: dict = {}  # each file loaded once, by its path


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with what it needs."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    bench_dir: Path

    def _module(self, folder: str, name: str):
        path = self.bench_dir / folder / f"{name}.py"
        if path not in _MODULES:
            _MODULES[path] = load_module(path, f"bench_{folder}_{name}")
        return _MODULES[path]

    def reader(self, metric: dict):
        """The per-layer metric's ``read(ctx)``."""
        return self._module("metrics", metric["name"]).read

    def counts(self, kernel: str):
        """The module of a kernel's operation and byte counts."""
        return self._module("counts", kernel)

    def loop(self):
        """The module of the traffic mix's loop."""
        return self._module("loops", self.traffic["loop"])


def _in_cell(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in reported if "moves" in metric else True


def load(root: Path | None = None) -> dict:
    """``BENCHMARK.json`` at the checkout's root (the benchmark folder's
    parent by default), its names checked."""
    root = BENCH_DIR.parent if root is None else Path(root)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    check_names(spec)
    return spec


def cell(name: str, root: Path | None = None) -> Cell:
    """The cell ``name`` of the benchmark at ``root``, its files read."""
    root = BENCH_DIR.parent if root is None else Path(root)
    spec = load(root)
    found = [w for w in spec["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r}; one of "
                       + ", ".join(w["name"] for w in spec["workloads"]))
    w = found[0]
    conf = next(c for c in spec["configs"] if c["name"] == w["config"])
    bench_dir = root / spec["paths"][0]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((bench_dir / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in spec["end_to_end"] if _in_cell(m, name, set())]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if _in_cell(m, name, reported)]
    return Cell(name, int(w["chips"]), config, traffic, e2e, per_layer, bench_dir)
