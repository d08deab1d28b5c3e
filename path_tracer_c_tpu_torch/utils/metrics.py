"""Metrics: rays/s counters and structured JSONL run logs.

The same throughput math as the JAX package's ``utils/metrics.py``: a
"ray" is one trace round of one pixel-sample, ``H * W * spp *
(max_bounces + 1)`` per render, counted whether or not the round ran.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from pathlib import Path

__all__ = ["rays_per_render", "shape_name", "MetricsLogger", "throughput"]


def rays_per_render(height: int, width: int, spp: int, max_bounces: int) -> int:
    """Nominal trace rounds of one render: ``max_bounces + 1`` per
    pixel-sample. The CUDA kernel stops a path once its throughput is
    zero, so it executes at most this many."""
    return height * width * spp * (max_bounces + 1)


def shape_name(shape) -> str:
    """``HxW/Sspp/Bb`` of a ``(height, width, spp, max_bounces)`` shape, as
    the measurement scripts name it on each line."""
    h, w, spp, bounces = shape
    return f"{h}x{w}/{spp}spp/{bounces}b"


def throughput(height, width, spp, max_bounces, seconds: float) -> float:
    """rays/sec for one timed render."""
    return rays_per_render(height, width, spp, max_bounces) / max(seconds, 1e-12)


@dataclass
class MetricsLogger:
    """Append-only JSONL metrics stream (loss curves, rays/s, bounce stats).

    ``path=None`` keeps records in memory only (tests).
    """

    path: str | None = None
    records: list = field(default_factory=list)

    def log(self, kind: str, **fields) -> dict:
        rec = {"ts": time.time(), "kind": kind, **fields}
        self.records.append(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return rec

    @staticmethod
    def read(path) -> list[dict]:
        """The records of a JSONL metrics file."""
        return [json.loads(line) for line in Path(path).read_text().splitlines() if line.strip()]
