"""Checkpoint and resume for long renders and fits.

A render persists its accumulated sample sum with the samples done so far
and the root seed. Sample streams key on (pixel, sample, seed) and every
engine takes a ``sample_offset``, so a render resumed at ``spp_done``
continues the streams it would have drawn: the finished render equals one
that ran through with the same chunks, bit for bit.

The file is the JAX package's (``utils/checkpoint.py``): a ``.npz`` with the
keys ``accum``, ``spp_done``, ``seed`` and ``meta``, so a render checkpoint
written by either package resumes in the other. ``accumulate`` folds a
chunk in with that package's float32 arithmetic, in its order, on the host:
both packages' accumulators agree bit for bit on the same radiance.

A fit persists its variables, the optimizer's state tensors, the step
counter and the loss history (``save_fit``); per-step seeds are
step-indexed (``grad/diff.py``), so a resumed fit continues bit for bit.
Every save goes to a temporary file in the same directory, then
``os.replace``.
"""

from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path

import numpy as np
import torch

__all__ = [
    "RenderCheckpoint", "save_render", "load_render", "accumulate",
    "save_fit", "load_fit",
]


class RenderCheckpoint:
    """Accumulated radiance sum (a float32 ``(H, W, 3)`` numpy array) and
    progress counters."""

    def __init__(self, accum, spp_done: int, seed: int, meta: dict | None = None):
        self.accum = np.asarray(accum, np.float32)
        self.spp_done = int(spp_done)
        self.seed = int(seed)
        self.meta = dict(meta or {})

    @property
    def image(self) -> np.ndarray:
        """Mean radiance so far: ``accum / max(spp_done, 1)`` in float32."""
        return self.accum / max(self.spp_done, 1)


def _save_atomic(path, **arrays) -> None:
    """``np.savez`` into a temporary file beside ``path``, then rename."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _json_bytes(obj) -> np.ndarray:
    return np.frombuffer(json.dumps(obj).encode(), dtype=np.uint8)


def save_render(path, ckpt: RenderCheckpoint) -> None:
    """Write a render checkpoint atomically."""
    _save_atomic(path, accum=ckpt.accum, spp_done=np.int64(ckpt.spp_done),
                 seed=np.int64(ckpt.seed), meta=_json_bytes(ckpt.meta))


def load_render(path) -> RenderCheckpoint:
    """Read a render checkpoint written by either package."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode()) if "meta" in z else {}
        return RenderCheckpoint(z["accum"], int(z["spp_done"]), int(z["seed"]), meta)


def _host(radiance) -> np.ndarray:
    if isinstance(radiance, torch.Tensor):
        radiance = radiance.detach().cpu().numpy()
    return np.asarray(radiance, np.float32)


def accumulate(ckpt: RenderCheckpoint | None, radiance, spp: int, seed: int,
               meta: dict | None = None) -> RenderCheckpoint:
    """Fold a chunk's ``spp``-sample mean (a tensor on any device, or an
    array) into the accumulator: ``accum + radiance * spp`` in float32 on
    the host. The seed must be the checkpoint's."""
    add = _host(radiance) * spp
    if ckpt is None:
        return RenderCheckpoint(add, spp, seed, meta)
    if ckpt.seed != seed:
        raise ValueError(f"seed mismatch: checkpoint {ckpt.seed} vs {seed}")
    return RenderCheckpoint(ckpt.accum + add, ckpt.spp_done + spp, seed, ckpt.meta)


def save_fit(path, step: int, params: dict, opt_state: dict, losses) -> None:
    """Persist a fit: ``params`` (name -> tensor: the variables and any
    state the fit carries beside them), ``opt_state`` (name -> tensor: the
    optimizer's state, flat), the step counter and the loss history. The
    tensors are saved in the dicts' order under ``p_{i}`` and ``o_{i}``,
    with their names, so that ``load_fit`` can check them. Atomic."""
    arrays = {f"p_{i}": t.detach().cpu().numpy() for i, t in enumerate(params.values())}
    arrays.update({f"o_{i}": t.detach().cpu().numpy() for i, t in enumerate(opt_state.values())})
    _save_atomic(path, step=np.int64(step), losses=np.asarray(losses, np.float64),
                 n_params=np.int64(len(params)), n_opt=np.int64(len(opt_state)),
                 p_names=_json_bytes(list(params)), o_names=_json_bytes(list(opt_state)),
                 **arrays)


def load_fit(path, params_like: dict, opt_state_like: dict):
    """Restore ``(step, params, opt_state, losses)`` saved by ``save_fit``.

    ``params_like`` and ``opt_state_like`` are dicts of tensors built as the
    fit builds them before it resumes: each restored tensor takes its
    template's dtype and device. A checkpoint whose tensor count, names or
    shapes differ from the templates' (another optimizer, parameterization
    or scene) raises ``ValueError``."""
    with np.load(path) as z:
        step = int(z["step"])
        losses = [float(x) for x in z["losses"]]
        n_p, n_o = int(z["n_params"]), int(z["n_opt"])
        names_p = json.loads(bytes(z["p_names"]).decode())
        names_o = json.loads(bytes(z["o_names"]).decode())
        leaves_p = [z[f"p_{i}"] for i in range(n_p)]
        leaves_o = [z[f"o_{i}"] for i in range(n_o)]

    def restore(like, names, leaves, what):
        if len(leaves) != len(like):
            raise ValueError(f"fit checkpoint {what} has {len(leaves)} tensors, the fit has "
                             f"{len(like)}: another optimizer or parameterization?")
        if names != list(like):
            raise ValueError(f"fit checkpoint {what} are {names}, the fit's {list(like)}")
        for (k, t), a in zip(like.items(), leaves):
            if a.shape != tuple(t.shape):
                raise ValueError(f"fit checkpoint {k} has shape {a.shape}, the fit's "
                                 f"{tuple(t.shape)}")
        return {k: torch.from_numpy(np.array(a)).to(t.device, t.dtype)
                for (k, t), a in zip(like.items(), leaves)}

    return (step, restore(params_like, names_p, leaves_p, "params"),
            restore(opt_state_like, names_o, leaves_o, "optimizer state"), losses)
