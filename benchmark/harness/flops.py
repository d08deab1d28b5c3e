"""The yardstick of a kernel's roofline share: float32 operations per event
and the bytes a render must move, and the least time the card could take.

A frozen copy of the arithmetic of the port's ``utils/flops.py``
(``kernel_op_counts`` for B1, B2 and B3, ``bound_ms``): operations counted
once from the kernels' CUDA sources, per event, by class (``alu``: add,
multiply, compare, select, min/max, divide; ``sqrt``: ``sqrtf`` and
``rsqrtf``; integer RNG work left out); bytes with each input read once
and each output written once. The events come from the benchmark's own
reference (``reference/tracer.count_events`` with the renderer each
kernel's ``counts/<kernel>.py`` names), never from the program's
counters, so the yardstick reads the same work whatever implements it.
"""

from __future__ import annotations

# Published peaks of one H100 SXM (NVIDIA's data sheet, at its 700 W power
# limit): 67 TFLOP/s float32 outside the tensor cores, a fused multiply-add
# counted as two, and 3.35 TB/s of device memory. The kernels are built with
# -fmad=false, so about half the float32 peak is the most they can reach.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


def _ops(alu: float, sqrt: float = 0) -> dict:
    return {"alu": alu, "sqrt": sqrt}


def _sum(*terms) -> dict:
    return {c: sum(n * ops[c] for n, ops in terms) for c in ("alu", "sqrt")}


# Per event: one sphere test, one triangle test, the rest of the closest
# hit, one shading round of the reference tier, one swept hit of B2.
OPS_SPHERE = _ops(28, 1)
OPS_TRIANGLE = _ops(61)
OPS_HIT_REST = _ops(24, 1)
OPS_SHADE = _ops(134, 4)
OPS_SWEEP = _ops(24)
# The physical kernel: a hit round, a diffuse vertex's direction, any other
# vertex's (the mirror's, the cheapest), one light sample up to its tests,
# what a shadow scan adds to the per-object tests.
OPS_PHYS_HIT = _ops(53, 1)
OPS_PHYS_DIFFUSE = _ops(63, 2)
OPS_PHYS_MIRROR = _ops(9)
OPS_PHYS_LIGHT = _ops(135, 4)
OPS_PHYS_SHADOW_REST = _ops(10)

KINDS = ("forward", "fused", "physical")


def counts(kind: str, dims: dict, height: int, width: int, spp: int, events: dict) -> dict:
    """``{"alu", "sqrt", "bytes"}`` of one render by the kernel of ``kind``
    (``forward`` B1, ``fused`` B2, ``physical`` B3) over a scene of
    ``dims`` (``spheres``, ``triangles``, ``materials``), given the events
    its threads ran (``rounds``; for ``physical`` also
    ``diffuse_vertices``, ``light_samples``, ``shadow_scans``)."""
    if kind not in KINDS:
        raise ValueError(f"unknown kernel kind {kind!r}; one of {', '.join(KINDS)}")
    n_sph, n_tri, n_mat = dims["spheres"], dims["triangles"], dims["materials"]
    pix_spp = height * width * spp
    rounds = events["rounds"]
    hit_rounds = max(rounds - pix_spp, 0)
    image = 12 * height * width
    if kind in ("forward", "fused"):
        scan = _sum((n_sph, OPS_SPHERE), (n_tri, OPS_TRIANGLE), (1, OPS_HIT_REST))
        ops = _sum((rounds, scan), (hit_rounds, OPS_SHADE))
        nbytes = 4 * (6 * n_sph + 14 * n_tri + 9 * n_mat + 17) + image
        if kind == "fused":
            ops = _sum((1, ops), (hit_rounds, OPS_SWEEP))
            nbytes += 4 * (9 * n_mat + 3) * height * width
    else:
        scan = _sum((n_sph, OPS_SPHERE), (n_tri, OPS_TRIANGLE))
        diffuse = events["diffuse_vertices"]
        per_shadow = _sum((1, scan), (n_sph + n_tri, _ops(1)), (1, OPS_PHYS_SHADOW_REST))
        ops = _sum((rounds, scan), (rounds, OPS_HIT_REST), (hit_rounds, OPS_PHYS_HIT),
                   (diffuse, OPS_PHYS_DIFFUSE), (max(hit_rounds - diffuse, 0), OPS_PHYS_MIRROR),
                   (events["light_samples"], OPS_PHYS_LIGHT),
                   (events["shadow_scans"], per_shadow))
        nbytes = 4 * (11 * n_sph + 19 * n_tri + 10 * n_mat + 19) + image
    return {**ops, "bytes": nbytes}


def least_seconds(c: dict):
    """The larger of the operations over 67 TFLOP/s and the bytes over
    3.35 TB/s: ``(seconds, "operations" or "bytes")``."""
    t_ops = (c["alu"] + c["sqrt"]) / PEAK_FP32
    t_bytes = c["bytes"] / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
