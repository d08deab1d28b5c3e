"""Where the forward kernel's time goes, against its speed of light.

The counterpart of ``scripts/sol_decompose.py`` for the hand kernel B1
(``csrc/render_fwd.cu``), on the same workload (the glossy scene, 1024^2,
64 spp, 8 bounces; ``small``: 256^2, 8 spp, 4 bounces). B1's operations
(``utils/flops``) over the per-class rates that kernel B6 measures give the
time B1 would take if it issued nothing but its counted operations, with no
lane idle; four probes account for the rest:

(a) fixed cost: B7 (``ops/sol_probes.sol_null``) on B1's exact launch
    does nothing but store the image. Called as B1 is called, its time is
    what a render call costs beside its rounds (the operand packing, the
    launch, the blocks' start and end, the store); launched on operands
    packed once, back to back, its time is the kernel's alone, and over
    the blocks it prices a block's start and end.
(b) table loads: B8 (``sol_micro``) with the table's scalars loaded at every
    object and hoisted; the difference prices one load, and B1's loads a
    round (5 floats a sphere test, 10 a triangle test, the 9 of the hit's
    material row) turn it into a share of B1's time.
(c) divergence: the thread-rounds B1 runs against the rounds its warps run
    (``render_kernel_round_counts``): a warp runs a sample for as many rounds
    as its longest lane, and the share ``1 - thread / warp lane-rounds`` of
    its lane slots is idle. Beside it, the share of the useful rounds (rays
    alive: hits and misses of ``render_bounce_stats``) that B1 never runs
    because it stops a path at zero throughput.
(d) the remainder: 1 less the counted operations' share, the divergence
    that inflates them, (a) and (b).

Every number is measured on the card; without a CUDA device this raises.
"""

from __future__ import annotations

import statistics

import torch

from . import flops
from .metrics import rays_per_render
from ..models.integrator import render_bounce_stats
from ..ops.camera import Camera
from ..ops.render_kernel import render_kernel, render_kernel_round_counts
from ..ops.sol_probes import (MICRO_NOBJ, MICRO_REPS, micro_table, sol_micro, sol_null,
                              sol_null_launcher)
from ..scene import demo

__all__ = ["sol_decompose", "table_loads_per_round"]


def table_loads_per_round(scene) -> int:
    """Scene-table words a round of B1 loads: ``sphere_t`` reads 5 floats of
    each sphere, ``triangle_t`` 10 of each triangle, and a hit round's
    ``fetch_material`` the 9 floats of one material row (the winners'
    material indices and triangle normals come on top)."""
    return 5 * scene.num_spheres + 10 * scene.num_triangles + 9


def _median_seconds(fn, seeds=(1, 2, 3), warm=100, repeat: int = 1) -> float:
    """Median device time of ``fn(seed)`` by CUDA events, after one warm
    call; with ``repeat``, of ``repeat`` calls back to back, divided."""
    fn(warm)
    times = []
    for seed in seeds:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(repeat):
            fn(seed)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) * 1e-3 / repeat)
    return statistics.median(times)


def sol_decompose(device="cuda", small: bool = False, rates: dict | None = None) -> dict:
    """B1's time at the bench workload, decomposed; one flat dict of
    numbers (keys as ``scripts/sol_decompose.py`` where the meaning carries
    over). ``rates``: the per-class rates of ``flops.measure_op_rates``
    (measured here if not given)."""
    device = flops._cuda_device(device)
    height = width = 256 if small else 1024
    spp, bounces = (8, 4) if small else (64, 8)
    scene, cam = demo.glossy_scene(device), Camera.reference(device)
    n_blocks = -(-width // 32) * -(-height // 8)
    nominal = rays_per_render(height, width, spp, bounces)

    fwd_s = _median_seconds(lambda s: render_kernel(scene, cam, height, width, spp, bounces, s))
    rounds = render_kernel_round_counts(scene, cam, height, width, spp, bounces, 1)
    thread_rounds, warp_rounds = rounds["thread_rounds"], rounds["warp_lane_rounds"]

    # (a) the fixed cost of a B1 call, and of its kernel's blocks
    null_s = _median_seconds(lambda s: sol_null(scene, cam, height, width))
    launch = sol_null_launcher(scene, cam, height, width)
    null_kernel_s = _median_seconds(lambda s: launch(), repeat=20)

    # (b) a table load
    table = micro_table(device)
    seed = lambda s: torch.tensor([[s]], dtype=torch.int32, device=device)
    reload_s = _median_seconds(lambda s: sol_micro(table, seed(s), height, width, hoisted=False))
    hoisted_s = _median_seconds(lambda s: sol_micro(table, seed(s), height, width, hoisted=True))
    thread_loads = MICRO_REPS * MICRO_NOBJ * 5 * height * width
    per_load_ns = max(reload_s - hoisted_s, 0.0) / thread_loads * 1e9
    loads_per_round = table_loads_per_round(scene)
    table_load_s = thread_rounds * loads_per_round * per_load_ns * 1e-9

    # (c) divergence, and the exit at zero throughput
    stats = render_bounce_stats(scene, cam, height, width, spp, bounces, 1)
    useful = int((stats["hits"] + stats["misses"]).sum())
    divergence = 1.0 - thread_rounds / warp_rounds
    zero_exit_saving = 1.0 - thread_rounds / useful

    # (d) the counted operations at the measured rates, and what is left
    if rates is None:
        rates = flops.measure_op_rates(device)
    report = flops.sol_report("forward", scene, height, width, spp, bounces, fwd_s,
                              {"rounds": thread_rounds}, alu_rate=rates["alu"],
                              transc_rate={c: rates[c] for c in flops.CLASSES[1:]})
    sol_fraction = report["sol_fraction"]
    divergence_of_fwd = report["sol_seconds"] * (warp_rounds / thread_rounds - 1.0) / fwd_s
    startup = null_s / fwd_s
    table_fraction = table_load_s / fwd_s
    return {
        "workload": f"{height}x{width}/{spp}spp/{bounces}b glossy, blocks 32x8",
        "device": torch.cuda.get_device_name(device),
        "fwd_seconds": fwd_s,
        "nominal_rounds": nominal,
        "executed_round_fraction": thread_rounds / nominal,
        "null_call_seconds": null_s,
        "null_kernel_seconds": null_kernel_s,
        "blocks": n_blocks,
        "per_block_startup_us": null_kernel_s / n_blocks * 1e6,
        "startup_fraction_of_fwd": startup,
        "block_startup_fraction_of_fwd": null_kernel_s / fwd_s,
        "micro_reload_seconds": reload_s,
        "micro_hoisted_seconds": hoisted_s,
        "per_table_load_ns": per_load_ns,
        "fwd_table_loads_per_round": loads_per_round,
        "table_load_fraction_of_fwd": table_fraction,
        "useful_thread_rounds": useful,
        "executed_thread_rounds": thread_rounds,
        "warp_lane_rounds": warp_rounds,
        "divergence_loss_fraction": divergence,
        "zero_exit_saving_fraction": zero_exit_saving,
        "measured_rates": rates,
        "sol_seconds": report["sol_seconds"],
        "sol_fraction": sol_fraction,
        "divergence_fraction_of_fwd": divergence_of_fwd,
        "remainder_fraction_of_fwd": 1.0 - sol_fraction - divergence_of_fwd - startup
                                     - table_fraction,
    }
