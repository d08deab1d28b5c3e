"""PyTorch port: the launch shape (``ops/render_kernel.TILES``, the
counterpart of the JAX package's ``tile``) on the CPU: the twin of the
kernels' pixel map, the warp groupings under each footprint, ``fit_tile``
and its refusals, the twins' independence of the tile, the JAX package's
Pallas kernels at two tiles against the port's twins, and the sweep
script's arguments. The kernels at every point are tested on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 18).

Tolerances: the JAX suite's for each kernel against its core path
(tests/test_pallas.py, tests/test_pallas_physical.py); the port's twins at
two tiles are the same computation and must be equal.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import path_tracer_c_tpu as J
from path_tracer_c_tpu.ops.pallas_kernels import render_pallas
from path_tracer_c_tpu.ops.pallas_physical import render_physical_pallas
from path_tracer_c_tpu.scene import demo as jdemo
import path_tracer_c_tpu_torch as P
from path_tracer_c_tpu_torch.ops import render_grad as rg
from path_tracer_c_tpu_torch.ops import render_kernel as rk
from path_tracer_c_tpu_torch.ops import render_physical as rp
from path_tracer_c_tpu_torch.ops import render_physical_grad as pg
from path_tracer_c_tpu_torch.scene import demo as pdemo

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def old_warp_lane_rounds(rounds):
    """The grouping before launch shapes (a warp: 32 columns of a row from a
    multiple of 32), pinned."""
    spp, height, width = rounds.shape
    n_warps = -(-width // 32)
    padded = torch.zeros((spp, height, 32 * n_warps), dtype=rounds.dtype)
    padded[..., :width] = rounds
    widest = padded.reshape(spp, height, n_warps, 32).amax(dim=-1)
    lanes = torch.clamp(width - 32 * torch.arange(n_warps), max=32)
    return int((widest * lanes).sum())


def brute_warp_lane_rounds(rounds, tile):
    """Warp lane-rounds by a loop over the launch's warps (``tile_pixels``):
    each warp's longest in-image lane, times its in-image lanes, a sample
    at a time."""
    spp, height, width = rounds.shape
    row, col, inside = rk.tile_pixels(tile, height, width)
    total = 0
    for b in range(row.shape[0]):
        for w in range(row.shape[1] // 32):
            sl = slice(32 * w, 32 * w + 32)
            m = inside[b, sl]
            if not m.any():
                continue
            r, c = row[b, sl][m], col[b, sl][m]
            for s in range(spp):
                total += int(rounds[s, r, c].max()) * int(m.sum())
    return total


@pytest.mark.parametrize("name", list(rk.TILES))
@pytest.mark.parametrize("rows, width", [(19, 45), (37, 80), (1, 1)])
def test_pixel_map_is_a_bijection_and_warps_are_footprints(name, rows, width):
    t = rk.TILES[name]
    row, col, inside = rk.tile_pixels(name, rows, width)
    pix = (row * width + col)[inside]
    assert pix.numel() == rows * width
    assert torch.equal(pix.sort().values, torch.arange(rows * width))
    # Each warp's 32 lanes fill one wh x ww footprint on the footprints' grid.
    r = row.reshape(row.shape[0], -1, 32)
    c = col.reshape(col.shape[0], -1, 32)
    assert torch.equal(r.amax(-1) - r.amin(-1), torch.full_like(r[..., 0], t.wh - 1))
    assert torch.equal(c.amax(-1) - c.amin(-1), torch.full_like(c[..., 0], t.ww - 1))
    assert bool((r.amin(-1) % t.wh == 0).all()) and bool((c.amin(-1) % t.ww == 0).all())
    # warp_map, which the twins group by, makes the same warps.
    warp, n_warps, lanes = rk.warp_map(rows, width, t.footprint)
    launch_warp = (torch.arange(row.numel()) // 32).reshape(row.shape)[inside]
    pairs = torch.unique(torch.stack([warp[pix], launch_warp]), dim=1)
    assert pairs.shape[1] == n_warps == torch.unique(warp).numel()
    assert int(lanes.sum()) == rows * width


def test_pixel_map_on_a_row_block():
    """A block of rows is a launch of its own: its pixels are the block's
    rows, from 0, and the streams key on row_start + row (RowBlock)."""
    row, col, inside = rk.tile_pixels("16x16/4x8", 37, 45)
    assert int(row[inside].max()) == 36 and int(col[inside].max()) == 44


@pytest.mark.parametrize("h, w", [(19, 45), (8, 32), (3, 100), (40, 33)])
def test_warp_lane_rounds_by_footprint(h, w):
    g = torch.Generator().manual_seed(h * w)
    rounds = torch.randint(0, 9, (3, h, w), generator=g)
    assert rk.warp_lane_rounds(rounds) == old_warp_lane_rounds(rounds)
    assert rk.round_groupings(rounds)["warp_lane_rounds_regen"] == old_warp_lane_rounds(
        rounds.sum(0)[None])
    for name, t in rk.TILES.items():
        assert rk.warp_lane_rounds(rounds, t.footprint) == brute_warp_lane_rounds(rounds, name)


def test_tile_names_and_refusals():
    assert rk.tile_point(None) == rk.TILES["8x16/4x8"] == rk.tile_point(rk.DEFAULT_TILE)
    assert rk.tile_point(None, "fwd") == rk.tile_point(None)
    assert rk.tile_point("16x16") == rk.TILES["16x16/2x16"]
    assert rk.tile_point((8, 16)) == rk.TILES["8x16/4x8"]
    assert rk.tile_point((8, 32, 4, 8)) == rk.TILES["8x32/4x8"]
    for bad in ((32, 128), "8x8", (8, 32, 2, 16), "fast", 7, (8.0, 32.0)):
        with pytest.raises(ValueError, match="no point"):
            rk.tile_point(bad)
    with pytest.raises(ValueError, match="render_phys_bwd"):
        rk.tile_point("16x32/1x32", "phys_bwd")
    assert "16x32/1x32" not in rk.KIND_TILES["phys_bwd"]
    assert all(len(rk.KIND_TILES[k]) == 7 for k in ("fwd", "fused", "phys", "phys_fused"))
    # B1's default moved to 8x16/4x8 (it won at both of its shapes); the others stay.
    for kind, const in (("fused", rg.FUSED_TILE), ("fused", rg.BWD_TILE),
                        ("phys", rk.KIND_DEFAULTS["phys"]),
                        ("phys_fused", pg.PHYS_FUSED_TILE), ("phys_bwd", pg.PHYS_BWD_TILE)):
        assert rk.tile_point(const).name == "8x32/1x32" == rk.tile_point(None, kind).name
    # The sweep library holds every point but each kernel's default.
    units = rk._sweep_units()
    assert len(units) == 29 and ("render_fwd", 0) in units and ("render_fwd", 6) not in units
    assert ("render_fused", 6) in units and ("render_fused", 0) not in units


def test_fit_tile_budgets():
    glossy = pdemo.glossy_scene("cpu")
    for kind in rk.KINDS:
        for name in rk.KIND_TILES[kind]:
            assert rk.fit_tile(kind, glossy, 64, 64, 8, name).name == name
    # B2's records: 32 rounds of 15 bytes for 512 threads pass a block's 227 KB.
    big = "16x32/1x32"
    assert rk.block_smem("fused", big, glossy, rg.MAX_BOUNCES) == 32 * 512 * 15 > rk.SMEM_OPTIN
    assert rg.fused_tile(glossy, 64, 64, rg.MAX_BOUNCES, big).name == "8x32/1x32"
    assert rg.fused_tile(glossy, 64, 64, 12, big).name == big  # 13 * 512 * 15 fits
    assert rk.fit_tile("fused", glossy, 64, 64, rg.MAX_BOUNCES, "16x16/4x8").name == "16x16/4x8"
    # B5's tables, one a warp: many materials shrink it to a point of fewer warps.
    many = pdemo.random_spheres_scene("cpu")
    mats = many.materials
    n = 1000
    first = {f.name: getattr(mats, f.name)[:1] for f in dataclasses.fields(mats)}
    grow = {k: v.repeat(n, *([1] * (v.dim() - 1))) for k, v in first.items()}
    many = dataclasses.replace(many, materials=dataclasses.replace(mats, **grow))
    assert rk.block_smem("phys_bwd", "8x32/1x32", many, 8, 1) > rk.SMEM_OPTIN
    assert rk.fit_tile("phys_bwd", many, 64, 64, 8, None, n_em_cap=1).name == "4x32/1x32"
    with pytest.raises(ValueError, match="footprint 2x16"):
        rk.fit_tile("phys_bwd", many, 64, 64, 8, "16x16/2x16", n_em_cap=1)
    # B1's, B3's and B4's blocks do not grow with the tile: every point fits.
    for kind in ("fwd", "phys", "phys_fused"):
        assert rk.fit_tile(kind, many, 64, 64, rg.MAX_BOUNCES, big).name == big
        with pytest.raises(ValueError, match="B2 and B5 only"):
            rk.block_smem(kind, big, many, rg.MAX_BOUNCES)
    assert pg.phys_fused_tile(glossy, 64, 64, 8, big).name == big


def _bad_tile_calls(scene, cam):
    g = torch.zeros((6, 10, 3))
    args = (scene, cam, 6, 10, 1, 2, 7)
    return {
        "render_kernel": lambda t: rk.render_kernel(*args, tile=t),
        "render_kernel_round_counts": lambda t: rk.render_kernel_round_counts(*args, tile=t),
        "render_fused": lambda t: rg.render_fused(*args, tile=t),
        "render_kernel_vjp": lambda t: rg.render_kernel_vjp(*args, tile=t),
        "render_fused_round_counts": lambda t: rg.render_fused_round_counts(*args, tile=t),
        "render_physical_kernel": lambda t: rp.render_physical_kernel(*args, tile=t),
        "render_physical_fused": lambda t: pg.render_physical_fused(*args, tile=t),
        "render_physical_kernel_vjp": lambda t: pg.render_physical_kernel_vjp(*args, tile=t),
        "render_physical_bwd": lambda t: pg.render_physical_bwd(scene, cam, g, 6, 10, 1, 2, 7,
                                                                tile=t),
        "packed_launcher": lambda t: rk.packed_launcher(scene, cam, 6, 10, 1, 2, tile=t),
        "render_physical packed_launcher": lambda t: rp.packed_launcher(scene, cam, 6, 10, 1,
                                                                        2, tile=t),
    }


@pytest.mark.parametrize("wrapper", list(_bad_tile_calls(None, None)))
def test_every_wrapper_refuses_a_non_point(wrapper):
    scene, cam = pdemo.glossy_scene("cpu"), P.Camera.reference("cpu")
    with pytest.raises(ValueError, match="no point"):
        _bad_tile_calls(scene, cam)[wrapper]((32, 128))


def test_vjp_without_a_gradient_runs_the_forward_kernel_at_its_own_tile(monkeypatch):
    """With no leaf requiring a gradient the vjp wrappers are the forward
    kernels, at the forward kernels' defaults, not at the gradient
    kernels' (B1's is not B2's)."""
    scene, cam = pdemo.glossy_scene("cpu"), P.Camera.reference("cpu")
    seen, fit = [], rk.fit_tile
    monkeypatch.setattr(rk, "fit_tile", lambda kind, *a, **k: seen.append(
        (kind, fit(kind, *a, **k))) or seen[-1][1])
    rg.render_kernel_vjp(scene, cam, 6, 10, 1, 2, 7)
    pg.render_physical_kernel_vjp(scene, cam, 6, 10, 1, 2, 7)
    assert seen == [("fwd", rk.tile_point(None, "fwd")), ("phys", rk.tile_point(None, "phys"))]
    assert rk.tile_point(None, "fwd") != rk.tile_point(rg.BWD_TILE)


def test_variants_take_no_tile():
    scene, cam = pdemo.glossy_scene("cpu"), P.Camera.reference("cpu")
    args = (scene, cam, 6, 10, 1, 2, 7)
    with pytest.raises(ValueError, match="takes no tile"):
        rk.render_kernel_round_counts(*args, variant="per_sample", tile="8x32/1x32")
    with pytest.raises(ValueError, match="takes no tile"):
        rp.render_physical_kernel_round_counts(*args, variant="global_tables", tile="4x32")


def test_twins_do_not_depend_on_the_tile_and_counts_follow_the_footprint():
    scene, cam = pdemo.glossy_scene("cpu"), P.Camera.reference("cpu")
    args = (scene, cam, 11, 37, 2, 3, 5)
    base = rk.render_kernel(*args, count_rounds=True)
    fused = rg.render_fused(*args, count_rounds=True)
    phys = rp.render_physical_kernel(*args, count_events=True)
    pfused = pg.render_physical_fused(*args, n_em_cap=1, count_events=True)
    rounds = rk.reference_pixel_rounds(*args)
    for name, t in rk.TILES.items():
        got = rk.render_kernel(*args, count_rounds=True, tile=name)
        assert torch.equal(got[0], base[0]) and got[1] == base[1]
        for x, y in zip(rg.render_fused(*args, count_rounds=True, tile=name), fused):
            assert torch.equal(x, y) if torch.is_tensor(x) else x == y
        got = rp.render_physical_kernel(*args, count_events=True, tile=name)
        assert torch.equal(got[0], phys[0]) and got[1] == phys[1]
        got = pg.render_physical_fused(*args, n_em_cap=1, count_events=True, tile=name)
        assert all(torch.equal(x, y) for x, y in zip(got[:3], pfused[:3]))
        assert got[3] == pfused[3]
        counts = rk.render_kernel_round_counts(*args, tile=name)
        assert counts == rk.round_groupings(rounds, t.footprint)
        assert counts["warp_lane_rounds"] == rk.warp_lane_rounds(rounds, t.footprint)
    fp_counts = {name: rg.render_fused_round_counts(*args, tile=name)["warp_lane_rounds"]
                 for name in rk.TILES}
    assert fp_counts["8x32/1x32"] == fp_counts["16x32/1x32"] == fp_counts["4x32/1x32"]
    assert fp_counts["16x16/4x8"] == fp_counts["8x32/4x8"] == fp_counts["8x16/4x8"]
    phys_counts = {name: rp.render_physical_kernel_round_counts(*args, tile=name)
                   for name in ("8x32/1x32", "16x16/2x16", "8x16/4x8")}
    assert len({c["thread_rounds"] for c in phys_counts.values()}) == 1
    g = torch.rand((11, 37, 3), generator=torch.Generator().manual_seed(0))
    ref = pg.render_physical_bwd(scene, cam, g, 11, 37, 2, 3, 5)
    got = pg.render_physical_bwd(scene, cam, g, 11, 37, 2, 3, 5, tile="8x16/4x8")
    assert torch.equal(got.materials.albedo, ref.materials.albedo)


def _jax_args(h, w, spp, bounces, seed):
    return (J.Camera.reference(), h, w, spp, bounces, jnp.uint32(seed))


def test_jax_tiles_and_the_twin_agree_forward():
    """render_pallas at two tiles (tests/test_pallas.py's shape and tiles)
    against each other and the twin at two points."""
    h, w, spp, bounces, seed = 16, 128, 2, 4, 11
    images = [np.asarray(render_pallas(jdemo.demo_scene(), *_jax_args(h, w, spp, bounces, seed),
                                       tile=tile, interpret=True))
              for tile in ((8, 128), (16, 128))]
    a, b = (rk.render_kernel(pdemo.demo_scene("cpu"), P.Camera.reference("cpu"), h, w, spp,
                             bounces, seed, tile=t) for t in ("8x32/1x32", "16x16/4x8"))
    assert torch.equal(a, b)
    for x in images[1:] + [a.numpy()]:
        err = np.abs(images[0].astype(np.float64) - x)
        assert np.quantile(err, 0.999) < 1e-4 and err.mean() < 1e-5


def test_jax_tiles_and_the_twin_agree_physical():
    """render_physical_pallas at two tiles (tests/test_pallas_physical.py's
    shape and tiles) against each other and the twin at two points."""
    h, w, spp, bounces, seed = 16, 128, 2, 3, 7
    images = [np.asarray(render_physical_pallas(
        jdemo.cornell_spheres_scene(), *_jax_args(h, w, spp, bounces, seed), tile=tile,
        interpret=True)) for tile in ((8, 128), (16, 128))]
    a, b = (rp.render_physical_kernel(pdemo.cornell_spheres_scene("cpu"),
                                      P.Camera.reference("cpu"), h, w, spp, bounces, seed,
                                      tile=t) for t in ("8x32/1x32", "16x16/2x16"))
    assert torch.equal(a, b)
    for x in images[1:] + [a.numpy()]:
        err = np.abs(images[0].astype(np.float64) - x)
        assert np.quantile(err, 0.99) < 1e-4
        assert (err > 1e-3).mean() < 0.01
        assert abs(images[0].mean() - x.mean()) < 2e-3


def test_sweep_script_parses_and_refuses_the_cpu():
    script = REPO / "scripts" / "torch_tile_sweep.py"
    sys.path.insert(0, str(script.parent))
    try:
        import torch_tile_sweep as s
    finally:
        sys.path.remove(str(script.parent))
    args = s.parse_args(["fwd", "8x32", "16x16/4x8"])
    assert args.mode == "fwd" and args.points == ["8x32", "16x16/4x8"]
    assert s.parse_args([]).mode == "both" and s.parse_args(["bwd"]).shapes == "headline"
    assert s.load_sweep(str(REPO)).parse_points(args.points) == ("8x32/1x32", "16x16/4x8")
    with pytest.raises(SystemExit):
        s.parse_args(["sideways"])
    res = subprocess.run([sys.executable, str(script), "fwd", "8x32"], capture_output=True,
                         text=True, timeout=120, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0 and "no CUDA device" in res.stderr


def test_the_sweep_loads_the_build_parsers_by_their_path():
    """``utils/tile_sweep._tools`` loads ``ops/build.py`` by its path,
    outside the package (a ``--tree`` may lack the parsers); there its
    parsers run, and nothing it imports needs the package."""
    from path_tracer_c_tpu_torch.utils import tile_sweep

    tools = tile_sweep._tools()
    text = ("ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'\n"
            "ptxas info    : Used 40 registers, 8 bytes spill stores, 4 bytes spill loads\n")
    assert tools.ptxas_entries(text) == {
        "_Z3fooPf": {"registers": 40, "spill_stores": 8, "spill_loads": 4}}


def test_sol_report_names_the_launch_shape():
    from path_tracer_c_tpu_torch.utils import flops

    scene = pdemo.glossy_scene("cpu")
    events = {"rounds": 100}
    kw = dict(alu_rate=3e13, transc_rate=1e12)
    assert flops.sol_report("forward", scene, 12, 20, 2, 3, 1e-3, events, **kw)["tile"] == \
        "8x16/4x8"
    assert flops.sol_report("fused", scene, 12, 20, 2, 3, 1e-3, events, **kw)["tile"] == \
        "8x32/1x32"
    rep = flops.sol_report("fused", scene, 12, 20, 2, 3, 1e-3, events, tile=(8, 16), **kw)
    assert rep["tile"] == "8x16/4x8"
    with pytest.raises(ValueError, match="no point"):
        flops.sol_report("forward", scene, 12, 20, 2, 3, 1e-3, events, tile=(32, 128), **kw)


def test_configs_tpu_tiles_are_ignored():
    """A TPU tile (configs' tile_h x tile_w: 32x128 is 4096 pixels) is no
    launch shape: the loader drops the keys, and the kernels launch at
    their default points."""
    from path_tracer_c_tpu_torch.utils.config import load

    cfg = load(REPO / "configs" / "config3_glossy_1024.json")
    assert not hasattr(cfg, "tile_h") and not hasattr(cfg, "tile_w")
    with pytest.raises(ValueError, match="no point"):
        rk.tile_point((32, 128))


def test_summarize_counts_a_win_only_beyond_the_spread():
    from path_tracer_c_tpu_torch.utils import tile_sweep as ts

    def run(label, points):
        # alone: the times given; as called: 0.5-0.9 ms of host work more.
        host = {"parent": 0.5, "this": 0.9, "this2": 0.6}[label]
        return {"label": label, "sweep": [
            {"kernel": "B1", "shape": shape, "point": p, "alone_ms": ms, "ms": ms + host}
            for shape, by in points.items() for p, ms in by.items()]}

    one = "8x32/1x32 (one shape)"
    runs = [run("parent", {"a": {one: 10.0}, "b": {one: 5.0}}),
            run("this", {"a": {"8x32/1x32": 10.2, "16x16/4x8": 9.5, "4x32/1x32": 10.1},
                         "b": {"8x32/1x32": 5.1, "16x16/4x8": 4.7, "4x32/1x32": 4.0}}),
            run("this2", {"a": {"8x32/1x32": 10.1, "16x16/4x8": 9.6, "4x32/1x32": 9.0},
                          "b": {"8x32/1x32": 5.0, "16x16/4x8": 4.8, "4x32/1x32": 4.1}})]
    got = ts.summarize(runs)["B1"]
    alone = got["shapes"]["a"]["alone"]
    assert alone["default"] == "8x32/1x32" and alone["spread_ms"] == pytest.approx(0.2)
    assert alone["points"]["16x16/4x8"]["won"]  # 9.6 < 10.0 - 0.2
    assert not alone["points"]["4x32/1x32"]["won"]  # 10.1 is within it
    assert got["beats_default"] == ["16x16/4x8"]
    # As called the host's spread (0.4 ms more) hides the same points.
    called = got["shapes"]["a"]["as called"]
    assert called["spread_ms"] == pytest.approx(0.6)
    assert not called["points"]["16x16/4x8"]["won"]
    assert got["beats_default_as_called"] == []
