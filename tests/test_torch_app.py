"""PyTorch port: the ``render`` CLI, its BMP against the JAX encoder, its
device and engine rules, and the package's independence from JAX."""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from path_tracer_c_tpu.utils.bitmap import bitmap_bytes as j_bitmap_bytes
import path_tracer_c_tpu_torch as P
from path_tracer_c_tpu_torch.app import main as app
from path_tracer_c_tpu_torch.ops import render_kernel as rk
from path_tracer_c_tpu_torch.utils import tracing

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
    ({"mesh": {"tile": 4, "spp": 2}, "spp": 2}, "spp 2 "),  # a mesh: eight CPU slots
    ({"checkpoint_every": 2, "spp": 4}, "spp 4/4 "),  # a chunked render
    ({"tri_nee": True}, "fit: 1 steps in "),  # in a fit of the reference tier: ignored
])
def test_unported_settings_name_the_roadmap_item(tmp_path, capsys, settings, item):
    """The render settings once refused by ROADMAP item now run. The
    physical tier renders and, since its gradient was ported, fits:
    `fit --mode geometry` and `tri_nee` in a fit run and print their
    result line. ``checkpoint_every``, refused until chunked renders were
    ported, renders in chunks and prints a line per chunk. A mesh, refused
    until the parallel layer was ported, renders through it on CPU slots."""
    cfg = tmp_path / "c.json"
    render = {"width": 8, "height": 8, "spp": 1, **(settings or {})}
    if "mesh" in render:
        cfg.write_text(json.dumps(render))
        app.main(["render", "--device", "cpu", "--config", str(cfg),
                  "--out", str(tmp_path / "x.bmp")])
        line = capsys.readouterr().out.splitlines()[0]
        assert line.startswith(item) and "(cuda on mesh 4x2 on cpu)" in line, line
        assert len((tmp_path / "x.bmp").read_bytes()) == 54 + 8 * 8 * 3
        return
    if item.startswith("spp "):
        cfg.write_text(json.dumps(render))
        app.main(["render", "--device", "cpu", "--config", str(cfg),
                  "--out", str(tmp_path / "x.bmp")])
        lines = capsys.readouterr().out.splitlines()
        assert [l.split()[1] for l in lines if l.startswith("spp ") and "/" in l.split()[1]] == [
            "2/4", "4/4"]
        assert len((tmp_path / "x.bmp").read_bytes()) == 54 + 8 * 8 * 3
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
    launches = tracing.counters()
    app.main(["render", "--device", "cpu", "--config", str(cfg)])
    assert (tmp_path / "c.bmp").exists()
    assert (tracing.counters() - launches)["launch.render_fwd"] == 0  # the twin ran


def test_port_does_not_import_jax():
    code = ("import sys, path_tracer_c_tpu_torch, path_tracer_c_tpu_torch.app.main, "
            "path_tracer_c_tpu_torch.ops.render_grad, path_tracer_c_tpu_torch.ops.build, "
            "path_tracer_c_tpu_torch.ops.render_physical, path_tracer_c_tpu_torch.models.physical, "
            "path_tracer_c_tpu_torch.ops.render_physical_grad, "
            "path_tracer_c_tpu_torch.grad.diff, path_tracer_c_tpu_torch.utils.config, "
            "path_tracer_c_tpu_torch.utils.flops, path_tracer_c_tpu_torch.utils.profiling, "
            "path_tracer_c_tpu_torch.utils.sol_decompose, path_tracer_c_tpu_torch.ops.sol_probes, "
            "path_tracer_c_tpu_torch.utils.checkpoint, path_tracer_c_tpu_torch.utils.native, "
            "path_tracer_c_tpu_torch.utils.termview, path_tracer_c_tpu_torch.parallel, "
            "path_tracer_c_tpu_torch.parallel.mesh, path_tracer_c_tpu_torch.parallel.render, "
            "path_tracer_c_tpu_torch.parallel.distributed, path_tracer_c_tpu_torch.models.split, "
            "path_tracer_c_tpu_torch.utils.capacity_sweep, path_tracer_c_tpu_torch.utils.geom_asym, "
            "path_tracer_c_tpu_torch.parallel.scaling, path_tracer_c_tpu_torch.utils.tile_sweep; "
            "from path_tracer_c_tpu_torch import parallel; "
            "from path_tracer_c_tpu_torch.models.split import render_split; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'path_tracer_c_tpu' not in sys.modules, 'the JAX package imported'")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, timeout=120)


def test_no_jax_in_port_sources():
    for path in (REPO / "path_tracer_c_tpu_torch").rglob("*.py"):
        text = path.read_text()
        assert "import jax" not in text and "from jax" not in text, path


def test_no_jax_in_port_scripts():
    """The port's scripts import neither JAX nor the JAX package."""
    scripts = sorted((REPO / "scripts").glob("torch_*.py"))
    assert {"torch_capacity_sweep.py", "torch_geom_asym_bench.py",
            "torch_scaling_bench.py", "torch_tile_sweep.py"} <= {p.name for p in scripts}
    jax_package = re.compile(r"^\s*(import|from)\s+path_tracer_c_tpu\b", re.M)
    for path in scripts:
        text = path.read_text()
        assert "import jax" not in text and "from jax" not in text, path
        assert not jax_package.search(text), path


# -- the mesh and the split engine ------------------------------------------------


def mesh_config(tmp_path, **render):
    cfg = tmp_path / "mesh.json"
    cfg.write_text(json.dumps({"width": 16, "height": 8, "spp": 4, "max_bounces": 2,
                               "scene": "demo", "mesh": {"tile": 2, "spp": 2}, **render}))
    return str(cfg)


@pytest.mark.parametrize("engine", ["cuda", "core", "physical", "physical_core"])
def test_render_with_a_mesh_goes_through_the_parallel_layer(tmp_path, capsys, monkeypatch,
                                                            engine):
    """A config's 2x2 mesh on --device cpu: four CPU slots through
    render_sharded, with the engine's name in render_sharded; the BMP is
    the sharded image's, and chunks of the render continue at their sample
    offset."""
    from path_tracer_c_tpu_torch import parallel
    from path_tracer_c_tpu_torch.utils.bitmap import bitmap_bytes

    seen = []
    real = parallel.render_sharded
    monkeypatch.setattr(parallel, "render_sharded",
                        lambda *a, **kw: seen.append((kw["engine"], kw.get("sample_offset")))
                        or real(*a, **kw))
    out = tmp_path / "m.bmp"
    app.main(["render", "--device", "cpu", "--config", mesh_config(tmp_path), "--engine", engine,
              "--checkpoint-every", "2", "--out", str(out)])
    assert f"({engine} on mesh 2x2 on cpu)" in capsys.readouterr().out
    name = {"physical": "physical_pallas", "physical_core": "physical"}.get(engine, engine)
    assert seen == [(name, 0), (name, 2)]
    scene, cam = P.demo.demo_scene("cpu"), P.Camera.reference("cpu")
    mesh = parallel.make_mesh(tile=2, spp=2, devices="cpu")
    a = real(scene, cam, 8, 16, 2, 2, 0, mesh, engine=name)
    b = real(scene, cam, 8, 16, 2, 2, 0, mesh, engine=name, sample_offset=2)
    img = ((a.numpy() * 2 + b.numpy() * 2) / 4).astype("float32")
    assert out.read_bytes() == bitmap_bytes(P.render_image_u8(torch.from_numpy(img)).numpy())


def test_fit_with_a_mesh_takes_sharded_steps(tmp_path, capsys):
    """fit with a 2x2 mesh on --device cpu: every step through
    make_train_step, logged with the mesh; a checkpoint resumes it."""
    cfg = tmp_path / "fit.json"
    cfg.write_text(json.dumps({"render": {"width": 16, "height": 16, "spp": 4,
                                          "max_bounces": 2, "scene": "diffuse",
                                          "mesh": {"tile": 2, "spp": 2}},
                               "steps": 4, "lr": 0.05}))
    metrics = tmp_path / "m.jsonl"
    app.main(["fit", "--device", "cpu", "--config", str(cfg), "--metrics", str(metrics)])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("fit on mesh 2x2: 4 steps in "), line
    recs = [json.loads(l) for l in metrics.read_text().splitlines()]
    steps = [r for r in recs if r["kind"] == "fit_step"]
    assert [r["step"] for r in steps] == [0, 1, 2, 3]
    assert all(r["mesh"] == [2, 2] and r["engine"] == "cuda" for r in steps)
    ck = tmp_path / "f.npz"
    app.main(["fit", "--device", "cpu", "--config", str(cfg), "--steps", "2",
              "--checkpoint-path", str(ck)])
    app.main(["fit", "--device", "cpu", "--config", str(cfg), "--checkpoint-path", str(ck)])
    resumed = capsys.readouterr().out.strip().splitlines()[-1]
    assert resumed.split(", loss ")[1] == line.split(", loss ")[1]


def test_fit_geometry_with_a_mesh_is_refused(tmp_path):
    cfg = tmp_path / "fit.json"
    cfg.write_text(json.dumps({"render": {"width": 16, "height": 16, "spp": 4,
                                          "scene": "cornell", "mesh": {"tile": 2, "spp": 1}},
                               "steps": 1}))
    with pytest.raises(SystemExit, match="a mesh shards the materials fit only"):
        app.main(["fit", "--device", "cpu", "--config", str(cfg), "--mode", "geometry"])


def test_split_with_a_mesh_is_refused(tmp_path):
    with pytest.raises(SystemExit, match="engine 'split' is a single-device"):
        app.main(["render", "--device", "cpu", "--config", mesh_config(tmp_path),
                  "--engine", "split", "--out", str(tmp_path / "s.bmp")])
    assert not (tmp_path / "s.bmp").exists()


def test_render_engine_split(tmp_path, capsys):
    from path_tracer_c_tpu_torch.models.split import render_split

    out = tmp_path / "s.bmp"
    app.main(["render", "--device", "cpu", "--scene", "demo", "--width", "16", "--height", "8",
              "--spp", "2", "--max-bounces", "3", "--engine", "split", "--out", str(out)])
    assert "(split on cpu)" in capsys.readouterr().out
    img = render_split(P.demo.demo_scene("cpu"), P.Camera.reference("cpu"), 8, 16, 2, 3, 0)
    assert out.read_bytes() == j_bitmap_bytes(P.render_image_u8(img).numpy())


def test_mesh_larger_than_the_devices_is_refused_by_count(tmp_path, monkeypatch):
    """On the default device the mesh is laid on the visible cards; more
    slots than cards is refused, naming their count, before a scene is
    built; a mesh naming its own devices may repeat one, but only devices of
    --device's type: slots of the other type are refused, naming both."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(SystemExit, match=r"mesh 2x2 refused: tile\*spp = 4 != 1 devices"):
        app.main(["render", "--config", mesh_config(tmp_path), "--out", str(tmp_path / "x.bmp")])
    assert not (tmp_path / "x.bmp").exists()
    from path_tracer_c_tpu_torch.utils.config import RenderConfig, MeshConfig

    cfg = RenderConfig(mesh=MeshConfig(tile=2, spp=2, devices=["cpu"] * 4))
    with pytest.raises(SystemExit, match=r"mesh 2x2 refused: its devices .*cpu.* are not "
                                         r"of --device cuda's type"):
        app._mesh(cfg, torch.device("cuda", 0))
    cfg.mesh.devices = ["cuda:0"] * 4
    assert app._mesh(cfg, torch.device("cuda", 0)).size == 4
    with pytest.raises(SystemExit, match=r"its devices .*cuda.* are not of --device cpu's type"):
        app._mesh(cfg, torch.device("cpu"))
    config = json.loads(Path(mesh_config(tmp_path)).read_text())
    config["mesh"]["devices"] = ["cpu"] * 4
    (tmp_path / "cpu_slots.json").write_text(json.dumps(config))
    with pytest.raises(SystemExit, match="not of --device cuda's type"):
        app.main(["render", "--config", str(tmp_path / "cpu_slots.json"),
                  "--out", str(tmp_path / "x.bmp")])
    assert not (tmp_path / "x.bmp").exists()
