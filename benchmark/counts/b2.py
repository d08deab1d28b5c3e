"""B2, the reference tier's fused primal and Jacobian kernel
(``csrc/render_fused.cu``): its name in the device trace, the reference
renderer that counts its rounds (a path alive until a miss or a death),
its operations and bytes, the Jacobian's planes written once
(``harness/flops.py``), and the program's own count of its rounds, which
only the controls read."""

from harness import flops
from reference import tracer

KERNEL = r"\brender_fused_kernel\b"
RENDER = tracer.render_fused


def counts(dims: dict, height: int, width: int, spp: int, events: dict) -> dict:
    return flops.counts("fused", dims, height, width, spp, events)


def program_events(scene, camera, height, width, spp, max_bounces, seed, jitter) -> dict:
    from path_tracer_c_tpu_torch.ops.render_grad import render_fused

    return {"rounds": render_fused(scene, camera, height, width, spp, max_bounces, seed,
                                   jitter=jitter, count_rounds=True)[2]}
