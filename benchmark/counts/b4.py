"""B4, the physical tier's fused primal and Jacobian kernel
(``csrc/render_phys_fused.cu``), with the sphere emitters' geometry planes:
its name in the device trace, the reference renderer that counts its
events (``reference/physical_fused.render_physical_fused``), its
operations and bytes, and the program's own count of those events, which
only the controls read.

The operations and bytes are a frozen copy of the port's
``utils/flops.kernel_op_counts("physical_fused_geom")``, built on B3's
(``harness/flops.py``): B3's forward rounds, then per hit round the sweep's
weights and adds, per light sample that counted what it adds to the sweep,
the cone chain's adjoint and the 12 adds into the geometry planes; the
bytes are B3's and the planes written once. The planes are counted at
``EMITTER_CAP`` tracked emitters: the geometry fit sizes the cap to the
scene's live sphere emitters, and the glossy scene has one, the sun."""

from harness import flops
from reference import physical_fused

KERNEL = r"\brender_phys_fused_kernel\b"
RENDER = physical_fused.render_physical_fused
EMITTER_CAP = 1

# Float32 operations per event, counted from the kernel's CUDA source (the
# port's utils/flops.py OPS_PF_SWEEP, OPS_PF_SWEEP_VALID, OPS_CONE_ADJOINT,
# OPS_PF_GEO_PLANES): a swept hit round, what a valid light sample adds to
# the sweep, the cone chain's adjoint, the adds into the geometry planes.
OPS_SWEEP = flops._ops(27)
OPS_SWEEP_VALID = flops._ops(18)
OPS_CONE_ADJOINT = flops._ops(177, 3)
OPS_GEO_PLANES = flops._ops(33)


def counts(dims: dict, height: int, width: int, spp: int, events: dict) -> dict:
    """``{"alu", "sqrt", "bytes"}`` of one render by B4 with its geometry
    planes, given B3's events (``rounds``, ``diffuse_vertices``,
    ``light_samples``, ``shadow_scans``) and ``valid_samples``."""
    base = flops.counts("physical", dims, height, width, spp, events)
    hit_rounds = max(events["rounds"] - height * width * spp, 0)
    valid = events["valid_samples"]
    ops = flops._sum((1, base), (hit_rounds, OPS_SWEEP), (valid, OPS_SWEEP_VALID),
                     (valid, OPS_CONE_ADJOINT), (valid, OPS_GEO_PLANES))
    planes = 9 * dims["materials"] + 3 + 12 * EMITTER_CAP
    return {**ops, "bytes": base["bytes"] + 4 * planes * height * width}


def program_events(scene, camera, height, width, spp, max_bounces, seed, jitter) -> dict:
    from path_tracer_c_tpu_torch.ops.render_physical import render_physical_kernel
    from path_tracer_c_tpu_torch.ops.render_physical_grad import render_physical_fused

    fwd = render_physical_kernel(scene, camera, height, width, spp, max_bounces, seed,
                                 jitter=jitter, count_events=True)[1]
    own = render_physical_fused(scene, camera, height, width, spp, max_bounces, seed,
                                jitter=jitter, n_em_cap=EMITTER_CAP, count_events=True)[-1]
    return {**fwd, "rounds": own["rounds"], "valid_samples": own["valid_samples"]}
