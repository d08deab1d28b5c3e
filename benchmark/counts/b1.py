"""B1, the reference tier's forward kernel (``csrc/render_fwd.cu``): its
name in the device trace, the reference renderer that counts its rounds,
its operations and bytes (``harness/flops.py``), and the program's own
count of its rounds, which only the controls read."""

from harness import flops
from reference import tracer

KERNEL = r"\brender_fwd_kernel\b"
RENDER = tracer.render_forward


def counts(dims: dict, height: int, width: int, spp: int, events: dict) -> dict:
    return flops.counts("forward", dims, height, width, spp, events)


def program_events(scene, camera, height, width, spp, max_bounces, seed, jitter) -> dict:
    from path_tracer_c_tpu_torch.ops.render_kernel import render_kernel

    return {"rounds": render_kernel(scene, camera, height, width, spp, max_bounces, seed,
                                    jitter=jitter, count_rounds=True)[1]}
