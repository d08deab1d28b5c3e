"""PyTorch port: the native host runtime, built from its source.

The library is compiled from ``native/src/pt_native.cpp`` into the
ignored ``build/native/`` and never from, or into, the tracked
``native/``. Its BMP bytes are ``utils/bitmap.bitmap_bytes``'s, which are
the JAX package's (``tests/test_torch_app.py``).
"""

import hashlib
import shutil
import threading
from pathlib import Path

import numpy as np
import pytest

from path_tracer_c_tpu.utils.bitmap import bitmap_bytes as j_bitmap_bytes
from path_tracer_c_tpu_torch.utils import bitmap, native

REPO = Path(__file__).resolve().parents[1]
TRACKED = REPO / "native" / "libpt_native.so"


def _img(h, w, seed=0):
    return np.random.default_rng(seed + h * w).integers(0, 256, (h, w, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the native library")
    assert native.available()
    return native


def test_builds_from_source_into_build_dir_only(lib):
    """A forced rebuild writes ``build/native/libpt_native.so`` with the
    source's hash beside it; the tracked library is byte for byte as it
    was."""
    before = hashlib.sha256(TRACKED.read_bytes()).hexdigest() if TRACKED.exists() else None
    assert lib.build()
    path = lib.library_path()
    assert path == REPO / "build" / "native" / "libpt_native.so" and path.exists()
    assert path.with_name(path.name + ".sha256").read_text() == lib._digest()
    assert lib._fresh() and lib.available()
    after = hashlib.sha256(TRACKED.read_bytes()).hexdigest() if TRACKED.exists() else None
    assert before == after


def test_unavailable_without_a_compiler(monkeypatch):
    """No g++: the build fails, ``available()`` is False, and the writers
    refuse to start."""
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_fresh", lambda: False)
    assert not native.build()
    assert not native.available()
    with pytest.raises(RuntimeError, match="could not be built"):
        native.AsyncBitmapWriter()


@pytest.mark.parametrize("h, w", [(1, 1), (3, 5), (16, 32), (37, 50), (100, 160)])
@pytest.mark.parametrize("y_inverted", [True, False])
def test_write_bitmap_bytes_equal_numpy(lib, tmp_path, h, w, y_inverted):
    """Every row padding (w % 4), both row orders, with and without the
    pool's row fan-out (h >= 64)."""
    img = _img(h, w)
    lib.write_bitmap(tmp_path / "n.bmp", img, y_inverted)
    data = (tmp_path / "n.bmp").read_bytes()
    assert data == bitmap.bitmap_bytes(img, y_inverted) == j_bitmap_bytes(img, y_inverted)


def test_write_bitmap_raises_on_an_unopenable_path(lib, tmp_path):
    with pytest.raises(OSError):
        lib.write_bitmap(tmp_path / "missing_dir" / "x.bmp", _img(4, 4))
    with pytest.raises(ValueError):
        lib.write_bitmap(tmp_path / "x.bmp", np.zeros((4, 4), np.uint8))


def test_async_writer_frames_equal_numpy(lib, tmp_path):
    """Frames up to 512x512 submitted back to back, each buffer overwritten
    right after its submit (the writer copies it): after drain every file
    holds its frame's bytes."""
    writer = lib.AsyncBitmapWriter()
    buf = np.empty((512, 512, 3), np.uint8)
    expected = {}
    for i, (h, w) in enumerate([(512, 512), (8, 13), (512, 512), (64, 100), (512, 512)]):
        img = _img(h, w, seed=i)
        view = buf[:h, :w]
        view[...] = img
        path = tmp_path / f"f{i}.bmp"
        writer.submit(path, view, True)
        view[...] = 0
        expected[path] = bitmap.bitmap_bytes(img)
    writer.drain()
    for path, data in expected.items():
        assert path.read_bytes() == data


def test_async_writer_drain_reports_a_dropped_frame(lib, tmp_path):
    """The library drops a frame whose file it cannot open; drain names it,
    and an old file at the path does not pass for the new frame."""
    writer = lib.AsyncBitmapWriter()
    stale = tmp_path / "ok.bmp"
    stale.write_bytes(bitmap.bitmap_bytes(_img(4, 4, seed=9)))
    writer.submit(stale, _img(4, 4), True)
    writer.submit(tmp_path / "no_such_dir" / "lost.bmp", _img(4, 4), True)
    with pytest.raises(OSError, match="1 of 2 frame"):
        writer.drain()
    assert stale.read_bytes() == bitmap.bitmap_bytes(_img(4, 4))
    writer.drain()  # nothing pending: nothing to report


def test_async_writer_from_threads(lib, tmp_path):
    """Two Python threads submitting to one writer: every frame lands."""
    writer = lib.AsyncBitmapWriter()
    lock = threading.Lock()

    def work(k):
        for i in range(6):
            img = _img(24, 40, seed=10 * k + i)
            with lock:
                writer.submit(tmp_path / f"t{k}_{i}.bmp", img, True)

    threads = [threading.Thread(target=work, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    writer.drain()
    for k in range(2):
        for i in range(6):
            data = (tmp_path / f"t{k}_{i}.bmp").read_bytes()
            assert data == bitmap.bitmap_bytes(_img(24, 40, seed=10 * k + i))


@pytest.mark.parametrize("n", [1, 3, 0])
def test_thread_pool(lib, n):
    """A pool of n threads (0: one a core); wait on an idle pool returns;
    close joins and is idempotent."""
    with lib.ThreadPool(n) as pool:
        assert pool.size == n if n > 0 else pool.size >= 1
        pool.wait()
    pool.close()


def test_render_names_its_writer(lib, tmp_path, monkeypatch, capsys):
    """`render` writes through numpy's encoder, as the JAX CLI does, whether
    or not the native library builds, and says so; its bytes are the native
    encoder's."""
    import json

    from path_tracer_c_tpu_torch.app import main as app

    argv = ["render", "--device", "cpu", "--scene", "diffuse", "--width", "24", "--height",
            "8", "--spp", "1", "--max-bounces", "1"]
    outs, writes, real = {}, [], bitmap.write_bitmap
    monkeypatch.setattr(bitmap, "write_bitmap",
                        lambda p, u8, **k: (writes.append((str(p), u8)), real(p, u8, **k))[1])
    for built in (True, False):
        monkeypatch.setattr(native, "available", lambda: built)
        out, metrics = tmp_path / f"{built}.bmp", tmp_path / f"{built}.jsonl"
        app.main(argv + ["--out", str(out), "--metrics", str(metrics)])
        assert capsys.readouterr().out.strip().endswith("writer numpy)")
        assert json.loads(metrics.read_text().splitlines()[-2])["writer"] == "numpy"
        assert [p for p, _ in writes].count(str(out)) == 1
        outs[built] = out.read_bytes()
    lib.write_bitmap(tmp_path / "native.bmp", writes[0][1], True)
    assert outs[True] == outs[False] == (tmp_path / "native.bmp").read_bytes()
