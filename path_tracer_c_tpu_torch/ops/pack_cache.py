"""Launch operands packed once, and reused while their sources are unchanged.

B1's and B3's wrappers (``render_kernel._launch``, ``render_physical._launch``)
pack the scene into the kernels' tables and the camera into 17 floats before
every launch, though a frame loop, a chunked render or a camera sweep hands
them the same tensors again. A ``PackCache`` keeps, in each of its slots,
the value the slot's last miss packed, under a ``Key`` of the tensors it was
packed from, and gives it back to a later call whose sources are the very
same tensors in the same state:

- identity by a weak reference to each source: an address or ``id()``
  comes back on the next tensor the allocator builds, so a reference proves
  it; and when any source dies, its reference's callback drops the entry, so
  no packed value outlives its scene;
- state by each source's version counter (``_version``, which every
  in-place edit through PyTorch bumps), storage address, shape, strides and
  device, and by the key's extra values (the image's size).

An inference tensor counts no versions: its key is None, which never hits
and is never stored, so such a call packs every time. An edit that PyTorch
does not count, through ``.data`` or a raw pointer, is not seen.

A stored value is detached from autograd, so it holds no graph, and is never
written; a tensor of it may share memory with a source (a contiguous index
passes through the packing as it is), which that source's version covers. A
slot holds one entry, replaced by the next miss: the callers name a slot by
the kernel and the stream, and every user of the wrappers reuses its most
recent scene and camera. Nothing here is specific to a device: the wrappers
use it for CUDA launches, and the tests run it on CPU tensors.
"""

from __future__ import annotations

import threading
import weakref

__all__ = ["Key", "PackCache", "key", "TABLES", "CAMERAS"]


class Key:
    """The sources of a packed value and their ``state`` at lookup."""

    __slots__ = ("sources", "state")

    def __init__(self, sources: tuple, state: tuple):
        self.sources, self.state = sources, state


def key(sources, *extra) -> Key | None:
    """The ``Key`` of a value packed from the tensors ``sources`` with the
    hashable ``extra`` values; None where a source is an inference tensor."""
    sources = tuple(sources)
    try:
        state = tuple((t._version, t.data_ptr(), t.shape, t.stride(), t.device) for t in sources)
    except RuntimeError:  # an inference tensor tracks no version
        return None
    return Key(sources, (state, extra))


def _detached(value):
    """``value`` (a tensor, or a tuple or dict of values) detached."""
    if isinstance(value, dict):
        return {k: _detached(x) for k, x in value.items()}
    if isinstance(value, tuple):
        return tuple(_detached(x) for x in value)
    return value.detach()


class PackCache:
    """One packed value a slot (any hashable name), under the ``Key`` of
    its sources; ``get`` gives it back only for the same sources in the same
    state, ``put`` stores one in place of the slot's last. Safe across
    threads."""

    def __init__(self):
        self._slots: dict = {}  # slot -> (token, weakrefs, state, value)
        # Reentrant: a source may die, and its callback run, on a thread
        # that holds the lock (a garbage collection inside ``put``).
        self._lock = threading.RLock()

    def __len__(self) -> int:
        return len(self._slots)

    def get(self, slot, k: Key | None):
        """The value stored in ``slot`` under ``k``, or None: no entry,
        another source, or a state that differs."""
        if k is None:
            return None
        with self._lock:
            entry = self._slots.get(slot)
        if entry is None:
            return None
        _, refs, state, value = entry
        if state != k.state or any(r() is not t for r, t in zip(refs, k.sources)):
            return None
        return value

    def put(self, slot, k: Key | None, value):
        """Store ``value``, packed from ``k``'s sources in ``k``'s state,
        detached, in ``slot``, until the next ``put`` there or the death of
        a source; returns what it stored (``value`` itself where ``k`` is
        None)."""
        if k is None:
            return value
        value = _detached(value)
        token = object()  # this entry, for its callbacks; it refers to nothing

        def drop(_, slot=slot, token=token):
            with self._lock:
                if self._slots.get(slot, (None,))[0] is token:
                    del self._slots[slot]

        refs = tuple(weakref.ref(t, drop) for t in k.sources)
        with self._lock:
            self._slots[slot] = (token, refs, k.state, value)
        return value


# The process's caches: the scene's tables, a slot for each kernel and
# stream, and the camera's parameters, a slot for each stream.
TABLES = PackCache()
CAMERAS = PackCache()
