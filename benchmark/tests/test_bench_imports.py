"""What a run loads: the harness and a whole run at a test's size load no
module whose top-level name is ``jax``, ``jaxlib``, ``flax`` or the JAX
package (names compared whole: the port's name begins with the JAX
package's), and the reference loads nothing of the port either."""

from __future__ import annotations

import json
import subprocess
import sys

from conftest import BENCH, ROOT

PROBE = """
import json, sys
sys.path[:0] = [{root!r}, {bench!r}]
{body}
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps(tops))
"""


def _tops(body: str) -> set:
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT), bench=str(BENCH),
                                                             body=body)],
                         capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_neither_jax_nor_the_port():
    tops = _tops("import reference.tracer, reference.fit, reference.scenes, reference.rng")
    assert not tops & {"jax", "jaxlib", "flax", "path_tracer_c_tpu", "path_tracer_c_tpu_torch"}


def test_a_run_loads_no_jax():
    tops = _tops("""
import time, torch
from harness import core, spec, window
for name in ("glossy_1024.render_physical", "glossy_1024.fit_materials"):
    cell = spec.cell(name)
    cell.config.update(width=16, height=8, spp=1, max_bounces=1)
    cell.traffic["steps"] = 3
    r = core.run_cell(window.Run(cell, 5, 0.1, True, torch.device("cpu"), time.perf_counter()))
    assert r["correct"], r
""")
    assert "path_tracer_c_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "path_tracer_c_tpu"}
