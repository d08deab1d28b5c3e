"""PyTorch port: the cache of B1's and B3's launch operands
(``ops/pack_cache.py``, ``render_kernel._pack``) on CPU tensors.

A launch reuses the tables and the camera's parameters an earlier launch
packed only while every source tensor is the same object in the same state;
an edit, a new scene or a new image size packs anew, a slot keeps only its
last miss, and an entry goes with its sources. The launches themselves run on the card
(``test_torch_cuda.py``); here the pack phase runs alone, its library load
stubbed.
"""

import gc
import weakref

import pytest
import torch

import path_tracer_c_tpu_torch as P
from path_tracer_c_tpu_torch.ops import pack_cache as pc
from path_tracer_c_tpu_torch.ops import render_kernel as rk
from path_tracer_c_tpu_torch.ops import render_physical as rp
from path_tracer_c_tpu_torch.scene import demo as pdemo
from path_tracer_c_tpu_torch.utils import tracing

torch.set_num_threads(1)

PACKS = {"fwd": rk._scene_operands, "phys": rp._all_operands}
TABLE_FIELDS = [f"{table}.{name}" for table, name, _ in rk._TABLE_FIELDS]
CAMERA_FIELDS = ["sky_color"] + [f"camera.{name}" for name in rk._CAMERA_FIELDS]


@pytest.fixture
def pack(monkeypatch):
    """One launch's pack phase (``render_kernel._pack``) on fresh caches:
    returns whether the tables and the camera's parameters were reused, and
    both values."""
    monkeypatch.setattr(rk, "_library", lambda stem, t: None)
    monkeypatch.setattr(pc, "TABLES", pc.PackCache())
    monkeypatch.setattr(pc, "CAMERAS", pc.PackCache())

    def call(scene, camera, kind="fwd", height=16, width=24, stream=0):
        before = tracing.counters()
        _, _, tables, par = rk._pack(kind, None, scene, camera, height, width, PACKS[kind],
                                     stream)
        moved = tracing.counters() - before
        stem = rk.KINDS[kind]
        assert moved[f"pack.hit.{stem}"] + moved[f"pack.miss.{stem}"] == 1
        return moved[f"pack.hit.{stem}"] == 1, moved["wait.camera_params"] == 0, tables, par

    return call


def inputs():
    return pdemo.glossy_scene("cpu"), P.Camera.reference("cpu")


def source(scene, camera, field):
    """The tensor a field name of ``TABLE_FIELDS`` or ``CAMERA_FIELDS`` names."""
    if field == "sky_color":
        return scene.sky_color
    table, name = field.split(".")
    return getattr(camera if table == "camera" else getattr(scene, table), name)


def flat(value):
    return [t for v in (value if isinstance(value, tuple) else (value,))
            for t in (v.values() if isinstance(v, dict) else v if isinstance(v, tuple) else (v,))]


def assert_equal(a, b):
    a, b = flat(a), flat(b)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("kind", list(PACKS))
def test_the_same_scene_hits(pack, kind):
    scene, cam = inputs()
    assert pack(scene, cam, kind)[:2] == (False, False)
    hit_tables, hit_camera, tables, par = pack(scene, cam, kind)
    assert hit_tables and hit_camera
    again = pack(scene, cam, kind)
    assert again[2] is tables and again[3] is par  # the stored tensors themselves
    assert_equal(tables, PACKS[kind](scene))
    assert torch.equal(par, rk._camera_params(cam, scene, 16, 24))


def _edit(t):
    """An in-place edit through PyTorch of a source of any of its dtypes."""
    if t.dtype == torch.bool:
        t.logical_not_()
    elif t.dtype == torch.int32:
        t.copy_(t.roll(1))
    else:
        t.add_(0.25)


@pytest.mark.parametrize("kind", list(PACKS))
@pytest.mark.parametrize("field", TABLE_FIELDS + CAMERA_FIELDS)
def test_an_in_place_edit_of_a_source_misses(pack, field, kind):
    scene, cam = inputs()
    pack(scene, cam, kind)
    assert pack(scene, cam, kind)[:2] == (True, True)
    _edit(source(scene, cam, field))
    hit_tables, hit_camera, tables, par = pack(scene, cam, kind)
    # Each field is a source of the tables or of the camera's parameters.
    assert (hit_tables, hit_camera) == ((False, True) if field in TABLE_FIELDS else (True, False))
    assert_equal(tables, PACKS[kind](scene))
    assert torch.equal(par, rk._camera_params(cam, scene, 16, 24))
    assert pack(scene, cam, kind)[:2] == (True, True)


def test_a_new_scene_equal_by_value_misses(pack):
    scene, cam = inputs()
    _, _, tables, _ = pack(scene, cam)
    other = pdemo.glossy_scene("cpu")
    hit_tables, hit_camera, again, _ = pack(other, cam)
    assert not hit_tables and not hit_camera  # the sky's colour is a new tensor too
    assert again is not tables
    assert_equal(again, tables)


def test_replaced_data_misses(pack):
    scene, cam = inputs()
    pack(scene, cam)
    radius = scene.spheres.radius
    radius.data = radius.data * 2.0  # the same tensor object, new memory
    hit_tables, _, tables, _ = pack(scene, cam)
    assert not hit_tables
    assert torch.equal(tables[0][:, 3], radius)


def test_a_new_image_size_misses_the_camera_only(pack):
    scene, cam = inputs()
    _, _, tables, par = pack(scene, cam, height=16, width=24)
    hit_tables, hit_camera, again, wide = pack(scene, cam, height=16, width=32)
    assert hit_tables and not hit_camera and again is tables
    assert float(wide[1]) == pytest.approx(2.0) and float(par[1]) == pytest.approx(1.5)
    # The camera's slot keeps the last size only; the tables stay.
    assert pack(scene, cam, height=16, width=24)[:2] == (True, False)
    assert pack(scene, cam, height=16, width=24)[:2] == (True, True)


def test_a_dead_reference_misses_and_no_source_is_kept():
    cache = pc.PackCache()
    t = torch.arange(4, dtype=torch.int32)
    k = pc.key([t], "x")
    stored = cache.put("slot", k, (t, t + 1))  # the value shares a source's memory, as an index may
    assert cache.get("slot", pc.key([t], "x")) is stored
    assert cache.get("slot", pc.key([t], "y")) is None  # another extra value
    state, ref = k.state, weakref.ref(t)
    del t, k
    gc.collect()
    assert ref() is None and len(cache) == 0  # the entry kept no source alive, and went with it
    # A tensor at the dead one's address and version: the entry is not its.
    assert cache.get("slot", pc.Key((torch.arange(4, dtype=torch.int32),), state)) is None
    assert torch.equal(stored[0], torch.arange(4, dtype=torch.int32))


@pytest.mark.parametrize("kind", list(PACKS))
def test_a_dead_scene_leaves_the_caches_empty(pack, kind):
    scene, cam = inputs()
    pack(scene, cam, kind)
    assert len(pc.TABLES) == 1 and len(pc.CAMERAS) == 1
    ref = weakref.ref(scene.spheres.center)
    del scene
    gc.collect()
    # The camera's entry goes too: the sky's colour is one of its sources.
    assert ref() is None and len(pc.TABLES) == 0 and len(pc.CAMERAS) == 0
    assert pack(pdemo.glossy_scene("cpu"), cam, kind)[:2] == (False, False)


def test_a_stored_value_holds_no_graph():
    cache = pc.PackCache()
    leaf = torch.ones(3, requires_grad=True)
    stored = cache.put("slot", pc.key([leaf]), (leaf * 2.0,))
    assert stored[0].grad_fn is None and not stored[0].requires_grad
    assert torch.equal(stored[0], torch.full((3,), 2.0))


def test_inference_tensors_always_miss(pack):
    with torch.inference_mode():
        scene, cam = inputs()
    assert rk._table_key(scene) is None and rk._camera_key(cam, scene, 16, 24) is None
    for _ in range(2):
        hit_tables, hit_camera, tables, _ = pack(scene, cam)
        assert not hit_tables and not hit_camera
    assert len(pc.TABLES) == 0 and len(pc.CAMERAS) == 0
    assert_equal(tables, rk._scene_operands(scene))


def test_the_size_bound_holds_one_entry_a_slot(pack):
    """The tables' slot is the kernel and the stream, the camera's the
    stream; each keeps the last miss only."""
    scene, cam = inputs()
    pack(scene, cam, "fwd")
    assert pack(scene, cam, "phys")[:2] == (False, True)  # its own tables, the same camera
    assert pack(scene, cam, "fwd")[:2] == (True, True)
    assert pack(scene, cam, "fwd", stream=1)[:2] == (False, False)
    assert pack(scene, cam, "fwd", stream=0)[:2] == (True, True)
    assert len(pc.TABLES) == 3 and len(pc.CAMERAS) == 2
    others = [pdemo.glossy_scene("cpu") for _ in range(3)]
    for other in others:
        assert pack(other, cam, "fwd")[:2] == (False, False)
    assert len(pc.TABLES) == 3 and len(pc.CAMERAS) == 2
    assert pack(scene, cam, "phys")[:2] == (True, False)  # B3's slot kept it
    assert pack(scene, cam, "fwd")[:2] == (False, True)
