"""PyTorch port: the ``render`` CLI, its BMP against the JAX encoder, its
device and engine rules, and the package's independence from JAX."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from path_tracer_c_tpu.utils.bitmap import bitmap_bytes as j_bitmap_bytes
import path_tracer_c_tpu_torch as P
from path_tracer_c_tpu_torch.app import main as app
from path_tracer_c_tpu_torch.ops import render_kernel as rk

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("engine", ["cuda", "core"])
def test_render_cpu_writes_jax_identical_bmp(tmp_path, engine):
    """At 16x32 on the CPU the CLI writes the JAX encoder's bytes for the
    same u8 image."""
    out = tmp_path / "out.bmp"
    app.main(["render", "--device", "cpu", "--engine", engine, "--scene", "demo",
              "--width", "32", "--height", "16", "--spp", "2", "--max-bounces", "3",
              "--seed", "5", "--out", str(out)])
    scene, cam = P.demo.demo_scene("cpu"), P.Camera.reference("cpu")
    render = rk.render_kernel if engine == "cuda" else P.render_radiance
    u8 = P.render_image_u8(render(scene, cam, 16, 32, 2, 3, 5)).numpy()
    assert out.read_bytes() == j_bitmap_bytes(u8)
    assert out.read_bytes() == P.bitmap_bytes(u8)


def test_ragged_cpu_render_reaches_the_kernel_path(tmp_path, monkeypatch):
    """The kernel masks the ragged edge, so --engine cuda renders 100x160
    through render_kernel (its twin on the CPU), never the core path."""
    calls = []
    twin = rk.render_kernel_reference

    def spy(scene, camera, height, width, *args, **kw):
        calls.append((height, width))
        return twin(scene, camera, height, width, *args, **kw)

    monkeypatch.setattr(rk, "render_kernel_reference", spy)
    monkeypatch.setattr(
        "path_tracer_c_tpu_torch.models.integrator.render_radiance",
        lambda *a, **k: pytest.fail("the core path ran"),
    )
    out, metrics = tmp_path / "r.bmp", tmp_path / "m.jsonl"
    app.main(["render", "--device", "cpu", "--scene", "diffuse", "--width", "160",
              "--height", "100", "--spp", "1", "--max-bounces", "1",
              "--out", str(out), "--metrics", str(metrics)])
    assert calls == [(100, 160)]
    data = out.read_bytes()
    assert len(data) == 54 + 160 * 3 * 100
    rec = json.loads(metrics.read_text().splitlines()[0])
    assert rec["kind"] == "render" and rec["engine"] == "cuda" and rec["device"] == "cpu"


def test_device_cuda_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        app.main(["render", "--scene", "demo", "--width", "8", "--height", "8",
                  "--spp", "1", "--out", str(tmp_path / "x.bmp")])
    assert not (tmp_path / "x.bmp").exists()


@pytest.mark.parametrize("settings, item", [
    (None, "geometry fit (physical): 1 steps in "),  # fit --mode geometry
    ({"mesh": {"tile": 4, "spp": 2}}, "A11"),
    ({"checkpoint_every": 2, "spp": 4}, "spp 4/4 "),  # a chunked render
    ({"tri_nee": True}, "fit: 1 steps in "),  # in a fit of the reference tier: ignored
])
def test_unported_settings_name_the_roadmap_item(tmp_path, capsys, settings, item):
    """The render settings still to be ported are refused by ROADMAP item.
    The physical tier renders and, since its gradient was ported, fits:
    `fit --mode geometry` and `tri_nee` in a fit run and print their
    result line. ``checkpoint_every``, refused until chunked renders were
    ported, renders in chunks and prints a line per chunk."""
    cfg = tmp_path / "c.json"
    render = {"width": 8, "height": 8, "spp": 1, **(settings or {})}
    if item.startswith("spp "):
        cfg.write_text(json.dumps(render))
        app.main(["render", "--device", "cpu", "--config", str(cfg),
                  "--out", str(tmp_path / "x.bmp")])
        lines = capsys.readouterr().out.splitlines()
        assert [l.split()[1] for l in lines if l.startswith("spp ") and "/" in l.split()[1]] == [
            "2/4", "4/4"]
        assert len((tmp_path / "x.bmp").read_bytes()) == 54 + 8 * 8 * 3
        return
    if item.startswith("A"):
        cfg.write_text(json.dumps(render))
        with pytest.raises(SystemExit, match=f"ROADMAP.md {item}"):
            app.main(["render", "--device", "cpu", "--config", str(cfg),
                      "--out", str(tmp_path / "x.bmp")])
        assert not (tmp_path / "x.bmp").exists()
        return
    cfg.write_text(json.dumps({"render": render, "steps": 1}))
    app.main(["fit", "--device", "cpu", "--config", str(cfg)]
             + (["--mode", "geometry"] if settings is None else []))
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(item) and " err " in line, line


def test_config_pallas_engine_maps_to_the_kernel(tmp_path):
    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps({"width": 16, "height": 8, "spp": 1, "max_bounces": 1,
                               "scene": "diffuse", "engine": "pallas", "tile_h": 128,
                               "output": str(tmp_path / "c.bmp")}))
    launches = rk.render_kernel.launches
    app.main(["render", "--device", "cpu", "--config", str(cfg)])
    assert (tmp_path / "c.bmp").exists()
    assert rk.render_kernel.launches == launches  # the twin ran on the CPU


def test_port_does_not_import_jax():
    code = ("import sys, path_tracer_c_tpu_torch, path_tracer_c_tpu_torch.app.main, "
            "path_tracer_c_tpu_torch.ops.render_grad, path_tracer_c_tpu_torch.ops.build, "
            "path_tracer_c_tpu_torch.ops.render_physical, path_tracer_c_tpu_torch.models.physical, "
            "path_tracer_c_tpu_torch.ops.render_physical_grad, "
            "path_tracer_c_tpu_torch.grad.diff, path_tracer_c_tpu_torch.utils.config, "
            "path_tracer_c_tpu_torch.utils.flops, path_tracer_c_tpu_torch.utils.profiling, "
            "path_tracer_c_tpu_torch.utils.sol_decompose, path_tracer_c_tpu_torch.ops.sol_probes, "
            "path_tracer_c_tpu_torch.utils.checkpoint, path_tracer_c_tpu_torch.utils.native, "
            "path_tracer_c_tpu_torch.utils.termview; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'path_tracer_c_tpu' not in sys.modules, 'the JAX package imported'")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, timeout=120)


def test_no_jax_in_port_sources():
    for path in (REPO / "path_tracer_c_tpu_torch").rglob("*.py"):
        text = path.read_text()
        assert "import jax" not in text and "from jax" not in text, path
