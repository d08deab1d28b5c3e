"""B3, the physical tier's forward kernel (``csrc/render_phys.cu``): its
name in the device trace, the reference renderer that counts its rounds,
diffuse vertices, light samples and shadow scans, its operations and
bytes (``harness/flops.py``), and the program's own count of those
events, which only the controls read."""

from harness import flops
from reference import tracer

KERNEL = r"\brender_phys_kernel\b"
RENDER = tracer.render_physical


def counts(dims: dict, height: int, width: int, spp: int, events: dict) -> dict:
    return flops.counts("physical", dims, height, width, spp, events)


def program_events(scene, camera, height, width, spp, max_bounces, seed, jitter) -> dict:
    from path_tracer_c_tpu_torch.ops.render_physical import render_physical_kernel

    return render_physical_kernel(scene, camera, height, width, spp, max_bounces, seed,
                                  jitter=jitter, count_events=True)[1]
