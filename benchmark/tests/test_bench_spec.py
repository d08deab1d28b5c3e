"""``BENCHMARK.json`` and the files it names: every cell resolves, the
names and units keep to their characters, and a cell added by files and
entries alone is picked up."""

from __future__ import annotations

import json
import shutil

import pytest
from conftest import BENCH, ROOT, small_run

from harness import core, spec, window

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves(name):
    cell = spec.cell(name)
    assert cell.chips == 1
    assert {"scene", "width", "height", "spp", "max_bounces", "fov_deg", "jitter"} <= set(cell.config)
    loop = cell.loop()
    assert all(callable(getattr(loop, f)) for f in ("run", "numbers", "count_at", "controls"))
    counts = cell.counts(cell.traffic["kernel"])
    assert counts.KERNEL and callable(counts.RENDER) and callable(counts.program_events)
    if "reference" in cell.traffic:
        assert callable(window.reference(cell.traffic["reference"]))
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(cell.reader(m))
        assert m["moves"] in e2e


def test_names_units_and_limits():
    spec.check_names(SPEC)
    assert set(SPEC) == KEYS["top"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert SPEC["command"][1].startswith(SPEC["paths"][0] + "/")
    assert 1 <= SPEC["run_seconds"] <= 51
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[key]:
            assert set(entry) - {"workloads"} == KEYS[key], entry["name"]
            for text in ("why", "layer", "source"):
                if text in entry:
                    assert 1 <= len(entry[text]) <= 200 and "\n" not in entry[text] \
                        and "\t" not in entry[text], (entry["name"], text)
    for c in SPEC["configs"]:
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert m["better"] in ("lower", "higher")
        for w in m.get("workloads", []):
            assert w in CELLS
    names = {p.stem for p in (BENCH / "metrics").glob("*.py")}
    assert names == {m["name"] for m in SPEC["per_layer"]}


def test_a_cell_from_added_files(tmp_path):
    """A copy of the benchmark gains a configuration's cell, a traffic mix
    with a loop of its own, and a metric by new files and entries only (the
    spheres32 configuration's file is already there); the cell runs and
    reports the metric."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    mix = json.loads((BENCH / "traffic" / "render_reference.json").read_text())
    mix.update(check_units=1, warmup=1, loop="frames")
    shutil.copy(BENCH / "loops" / "render.py", tmp_path / "benchmark" / "loops" / "frames.py")
    (tmp_path / "benchmark" / "traffic" / "render_once.json").write_text(json.dumps(mix))
    (tmp_path / "benchmark" / "metrics" / "frame_max_ms.py").write_text(
        "def read(ctx):\n    return max(ctx.spans['frame_s']) * 1e3\n")
    bench["configs"].append({"name": "spheres32", "source": "https://github.com/MysteryCoder456/path_tracer_c",
                             "file": "benchmark/configs/spheres32.json", "reduced": [],
                             "why": "a test's configuration"})
    new = [{"name": "spheres32.render_once", "config": "spheres32", "traffic": "render_once",
            "chips": 1, "why": "a test's cell"},
           {"name": "spheres32.fit_materials", "config": "spheres32", "traffic": "fit_materials",
            "chips": 1, "why": "a test's cell"}]
    bench["workloads"] += new
    joins = {"render_once": {"rays_per_s", "frame_p95_ms", "device_idle_pct.render",
                             "render_call_ms", "b1_roofline_pct"},
             "fit_materials": {"fit_step_ms", "device_idle_pct.fit", "adam_step_ms",
                               "b2_roofline_pct"}}
    for m in bench["end_to_end"] + bench["per_layer"]:
        for cell in new:
            if m["name"] in joins[cell["traffic"]]:
                m["workloads"].append(cell["name"])
    bench["per_layer"].append({"name": "frame_max_ms", "unit": "ms", "better": "lower",
                               "source": "host_clock", "layer": "device", "moves": "rays_per_s",
                               "workloads": ["spheres32.render_once"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    for name, traced, key in (("spheres32.render_once", False, "rays_per_s"),
                              ("spheres32.render_once", True, "frame_max_ms"),
                              ("spheres32.fit_materials", False, "fit_step_ms"),
                              ("spheres32.fit_materials", True, "adam_step_ms")):
        result = core.run_cell(small_run(name, traced=traced, root=tmp_path))
        assert result["correct"] and key in result["metrics"], (name, result)
