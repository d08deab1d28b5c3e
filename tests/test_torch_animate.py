"""PyTorch port: the `animate` sweep and the terminal view against the JAX
package.

Each frame is the port's own render at that frame's camera and seed,
encoded; each camera is the JAX package's ``Camera.look_at`` on the same
eye, bit for bit; the terminal view's text is the JAX package's.
"""

import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from path_tracer_c_tpu.ops.camera import Camera as JCamera
from path_tracer_c_tpu.utils import termview as jtermview
import path_tracer_c_tpu_torch as P
from path_tracer_c_tpu_torch.app import main as app
from path_tracer_c_tpu_torch.ops import render_kernel as rk
from path_tracer_c_tpu_torch.ops import render_physical as rp
from path_tracer_c_tpu_torch.utils import bitmap, native, termview, tracing
from path_tracer_c_tpu_torch.utils.config import AnimationConfig, load, save

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CONFIG5 = REPO / "configs" / "config5_sweep_2048_multihost.json"

RENDERS = {"cuda": rk.render_kernel, "core": P.render_radiance,
           "physical": rp.render_physical_kernel}


def _animate(tmp_path, engine="cuda", frames=3, extra=()):
    out = tmp_path / "frames"
    metrics = tmp_path / "m.jsonl"
    app.main(["animate", "--device", "cpu", "--scene", "demo", "--engine", engine,
              "--width", "16", "--height", "8", "--spp", "2", "--max-bounces", "2",
              "--frames", str(frames), "--out-dir", str(out), "--metrics", str(metrics),
              *extra])
    *recs, spans = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert spans["kind"] == "spans"  # the recording's, last (tests/test_torch_tracing.py)
    return sorted(out.glob("frame_*.bmp")), recs


@pytest.mark.parametrize("engine", ["cuda", "core", "physical"])
def test_frames_are_the_renders_at_their_cameras(tmp_path, engine):
    """3 frames that differ; frame f is the engine's render at the orbit's
    camera f and seed 0 + f, through ``render_image_u8``; the cameras are
    the JAX package's ``look_at`` on the same eyes."""
    frames, recs = _animate(tmp_path, engine)
    assert [f.name for f in frames] == [f"frame_{i:04d}.bmp" for i in range(3)]
    data = [f.read_bytes() for f in frames]
    assert len(set(data)) == 3
    acfg = AnimationConfig(frames=3)
    scene = P.demo.demo_scene("cpu")
    for f, cam in enumerate(app._orbit_cameras(acfg, "cpu")):
        ang = 2.0 * np.pi * f / 3
        eye = (8.0 * np.sin(ang), 1.5, 6.0 - 8.0 * np.cos(ang))
        jcam = JCamera.look_at(eye, (0.0, 0.0, 6.0), fov_deg=90.0)
        for name in ("origin", "right", "up", "forward", "fov"):
            np.testing.assert_array_equal(np.asarray(getattr(jcam, name)),
                                          getattr(cam, name).numpy())
        img = RENDERS[engine](scene, cam, 8, 16, 2, 2, f, jitter=False)
        assert data[f] == bitmap.bitmap_bytes(P.render_image_u8(img).numpy())
    writer = "native" if native.available() else "numpy"
    assert [r["frame"] for r in recs if r["kind"] == "frame"] == [0, 1, 2]
    assert all(r["writer"] == writer and r["engine"] == engine for r in recs)
    assert recs[-1]["kind"] == "animate" and recs[-1]["frames"] == 3


def test_numpy_writer_writes_the_same_frames(tmp_path, monkeypatch):
    """Without the native library the frames are numpy's, byte for byte the
    native writer's, and the metrics and the printed line say which wrote."""
    native_frames, _ = _animate(tmp_path / "a")
    monkeypatch.setattr(native, "available", lambda: False)
    numpy_frames, recs = _animate(tmp_path / "b")
    assert [f.read_bytes() for f in native_frames] == [f.read_bytes() for f in numpy_frames]
    assert {r["writer"] for r in recs} == {"numpy"}


def test_live_draws_every_frame(tmp_path, capsys):
    """--live draws each frame as ANSI truecolor half-blocks with its caption,
    redrawn in place after the first."""
    _animate(tmp_path, extra=["--live"])
    out = capsys.readouterr().out
    assert out.count("frame 2/3\n") == 1 and "\x1b[38;2;" in out and "▀" in out
    assert out.count("\x1b[0J") == 2


def test_render_live_shows_each_chunk(tmp_path, capsys):
    """`render --live` at 8 spp: chunks of 1 spp, 8 views."""
    app.main(["render", "--device", "cpu", "--scene", "diffuse", "--width", "16", "--height",
              "8", "--spp", "8", "--max-bounces", "1", "--out", str(tmp_path / "l.bmp"), "--live"])
    out = capsys.readouterr().out
    assert [f"spp {i}/8\n" in out for i in range(1, 9)] == [True] * 8
    assert out.count("\x1b[0J") == 7


def test_config5_on_one_device_and_its_mesh_refused(tmp_path):
    """Config 5 loads unchanged; cut to 16x16, 2 spp, 2 bounces and 2 frames
    with its mesh set to 1x1 it sweeps through its engine (pallas, the
    kernel); with its 4x2 mesh on a machine of one card it is refused with
    the device count, before any scene is built."""
    acfg = load(CONFIG5, AnimationConfig)
    r = acfg.render
    assert (r.width, r.height, r.spp, r.max_bounces, r.scene, r.engine, acfg.frames) == (
        2048, 2048, 256, 4, "demo", "pallas", 48)
    assert (r.mesh.tile, r.mesh.spp, acfg.target) == (4, 2, (0.0, 0.0, 6.0))
    with pytest.MonkeyPatch.context() as mp:  # one card, seen by the mesh only
        mp.setattr(torch.cuda, "is_available", lambda: True)
        mp.setattr(torch.cuda, "device_count", lambda: 1)
        mp.setattr(torch.cuda, "current_device", lambda: 0)
        with pytest.raises(SystemExit, match=r"mesh 4x2 refused: tile\*spp = 8 != 1 devices"):
            app.main(["animate", "--config", str(CONFIG5), "--frames", "1",
                      "--out-dir", str(tmp_path / "refused")])
    assert not (tmp_path / "refused").exists()
    r.width = r.height = 16
    r.spp, r.max_bounces, acfg.frames = 2, 2, 2
    r.mesh.tile = r.mesh.spp = 1
    acfg.out_dir = str(tmp_path / "c5")
    small = tmp_path / "c5.json"
    save(acfg, small)
    assert load(small, AnimationConfig) == acfg
    launches = tracing.counters()
    app.main(["animate", "--device", "cpu", "--config", str(small)])
    frames = sorted((tmp_path / "c5").glob("frame_*.bmp"))
    assert len(frames) == 2 and all(len(f.read_bytes()) == 54 + 16 * 16 * 3 for f in frames)
    assert (tracing.counters() - launches)["launch.render_fwd"] == 0  # the twin ran
    cam = app._orbit_cameras(acfg, "cpu")[1]
    img = rk.render_kernel(P.demo.demo_scene("cpu"), cam, 16, 16, 2, 2, 1)
    assert frames[1].read_bytes() == bitmap.bitmap_bytes(P.render_image_u8(img).numpy())


@pytest.mark.parametrize("shape, budget", [((37, 51), (100, 28)), ((8, 16), (10, 5)),
                                           ((33, 7), (7, 3))])
def test_terminal_view_text_is_jaxs(shape, budget):
    """frame_to_ansi and two redraws of TerminalViewer write the JAX
    package's text."""
    rng = np.random.default_rng(sum(shape))
    imgs = [rng.integers(0, 256, (*shape, 3), dtype=np.uint8) for _ in range(2)]
    assert termview.frame_to_ansi(imgs[0], *budget) == jtermview.frame_to_ansi(imgs[0], *budget)
    streams = []
    for mod in (termview, jtermview):
        s = io.StringIO()
        viewer = mod.TerminalViewer(s, *budget)
        for i, img in enumerate(imgs):
            viewer.show(img, caption=f"frame {i}")
        streams.append(s.getvalue())
    assert streams[0] == streams[1]
