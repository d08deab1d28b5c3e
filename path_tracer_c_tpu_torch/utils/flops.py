"""Operation accounting, the op-rate calibration kernel (B6), and the
speed-of-light report.

The counterpart of ``path_tracer_c_tpu/utils/flops.py``. Three parts:

- **What a render costs.** The hand kernels' float32 operations are counted
  once, from their CUDA sources, per event (one sphere test, one shading
  round, one light sample, ...), by class: ``alu`` (add, multiply, compare,
  select, min/max, divide), ``sqrt`` (``sqrtf``, ``rsqrtf``), ``trig`` and
  ``explog``. The kernels call no ``cosf`` or ``logf`` (``sincos_2pi`` is a
  polynomial), so their ``trig`` and ``explog`` counts are 0.
  :func:`kernel_op_counts` multiplies these by the events a kernel's own
  counting instantiation reports (``count_rounds``, ``count_events``): one
  definition of each kernel's operations, from which both the data-sheet
  bound (:func:`bound_ms`) and the measured one (:func:`sol_report`) come.
- **What the card can do.** :func:`measure_op_rate` times kernel B6
  (``csrc/calib.cu``), dependent chains of one operation class on every
  thread of a full launch, and returns the rate the card sustains through
  the whole stack for that class. It needs a CUDA device: no rate is made up
  on the CPU. :func:`count_ops` counts the aten operations a PyTorch call
  dispatches, by the same classes.
- **The report.** :func:`sol_report`: a render's counts over the measured
  per-class rates, against its measured time.
"""

from __future__ import annotations

import ctypes

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..ops import render_kernel as rk
from ..ops.rng import _f32, sqrt_rn
from ..ops.sol_probes import MICRO_NOBJ, MICRO_REPS
from . import tracing

__all__ = [
    "CLASSES", "PEAK_FP32", "PEAK_BYTES", "kernel_op_counts", "probe_op_counts", "bound_ms",
    "measured_bound_ms", "count_ops", "calib_kernel", "calib_reference", "calib_ops",
    "measure_op_rate", "measure_op_rates", "sol_report", "SOURCE_CALIB", "REPLACES_CALIB",
]

SOURCE_CALIB = "path_tracer_c_tpu_torch/csrc/calib.cu"
REPLACES_CALIB = "path_tracer_c_tpu/utils/flops.py:268"

CLASSES = ("alu", "sqrt", "trig", "explog")
_TRANSC = CLASSES[1:]

# Published peaks of one H100 SXM (NVIDIA's data sheet, at 700 W): 67 TFLOP/s
# float32 outside the tensor cores, counting a fused multiply-add as two, and
# 3.35 TB/s of device memory. The kernels are built with -fmad=false, so a
# multiply and an add issue separately and half that rate is their ceiling;
# the data-sheet bound is still stated against the published figure, and
# sol_report states the one at the rates B6 measures.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


def _ops(alu: float, sqrt: float = 0) -> dict:
    return {"alu": alu, "sqrt": sqrt, "trig": 0, "explog": 0}


def _sum(*terms) -> dict:
    """Class-wise sum of ``(count, ops)`` pairs."""
    return {c: sum(n * ops[c] for n, ops in terms) for c in CLASSES}


# Float32 operations per event, counted from csrc/pt_common.cuh and
# csrc/render_fused.cu, each add, multiply, compare, max, divide and root as
# one (integer RNG work is left out): one sphere test (one sqrtf), one
# triangle test, the rest of closest_hit (one rsqrtf), one call of shade()
# (sqrtf for the sphere sample, rsqrtf for the normal, sqrtf for the
# refraction and for the offset), one swept hit of the fused kernel.
OPS_SPHERE = _ops(28, 1)
OPS_TRIANGLE = _ops(61)
OPS_HIT_REST = _ops(24, 1)
OPS_SHADE = _ops(134, 4)
OPS_SWEEP = _ops(24)
# The physical kernel (csrc/pt_phys.cuh), counted the same way: what every
# hit round does (Le, the 7 draws' conversions, the hit point, the offset with
# its sqrtf, albedo, the next origin, the exit test); the new direction of a
# diffuse vertex (cosine-weighted: two roots, sincos_2pi, the basis) and of
# any other (the mirror, the cheapest: a refraction costs more); one light
# sample of a sphere up to its tests (cone, basis, the full-b distance: four
# roots); and what a shadow scan adds to the per-object tests (the ray's d.d,
# one min per object, the visibility compare).
OPS_PHYS_HIT = _ops(53, 1)
OPS_PHYS_DIFFUSE = _ops(63, 2)
OPS_PHYS_MIRROR = _ops(9)
OPS_PHYS_LIGHT = _ops(135, 4)
OPS_PHYS_SHADOW_REST = _ops(10)
# The physical gradient kernels (csrc/render_phys_fused.cu,
# csrc/render_phys_bwd.cu, csrc/pt_phys.cuh). The fused kernel: one swept hit
# (the suffix, the albedo, emission and transparency planes' weights and adds,
# the carry), what a valid light sample adds to it (nee and emw and the
# emitter's three adds), what rough_grad adds (drg, three products, three
# adds); the cone chain's adjoint (69 forward with three roots, 111 back; the
# triangle chain's is 72 and 111) and the 12 products and adds into the
# planes with the closure's 9. The two-pass kernel: one swept hit with its
# cotangent terms, what a valid light sample adds, and the geometry term
# beside the adjoint.
OPS_PF_SWEEP, OPS_PF_SWEEP_VALID, OPS_PF_SWEEP_ROUGH = _ops(27), _ops(18), _ops(9)
OPS_CONE_ADJOINT, OPS_PF_GEO_PLANES = _ops(177, 3), _ops(33)
OPS_PB_SWEEP, OPS_PB_SWEEP_VALID, OPS_PB_GEO = _ops(43), _ops(27), _ops(20)

KINDS = ("forward", "fused", "physical", "physical_fused", "physical_fused_geom",
         "physical_bwd")


def _reference_table_bytes(scene) -> int:
    """The reference tier's tables (6 words a sphere, 14 a triangle, 9 a
    material) and the 17 camera and sky words."""
    return 4 * (6 * scene.num_spheres + 14 * scene.num_triangles + 9 * scene.num_materials + 17)


def _physical_table_bytes(scene, words_per_material: int = 10) -> int:
    """The reference tier's tables and the emitter tables (5 words a sphere,
    5 a triangle, 1 a material, 2 counts)."""
    return 4 * (11 * scene.num_spheres + 19 * scene.num_triangles
                + words_per_material * scene.num_materials + 19)


def _physical_ops(scene, pixels_spp: int, events: dict) -> dict:
    """The physical kernel's forward rounds: every round scans the scene
    once, at least ``rounds - H W spp`` rounds hit and shade, a diffuse vertex
    takes the cosine-weighted direction and any other at least the mirror's,
    and the light samples and shadow scans are those the data asked for."""
    scan = _sum((scene.num_spheres, OPS_SPHERE), (scene.num_triangles, OPS_TRIANGLE))
    hit_rounds = max(events["rounds"] - pixels_spp, 0)
    diffuse = events["diffuse_vertices"]
    per_shadow = _sum((1, scan), (scene.num_spheres + scene.num_triangles, _ops(1)),
                      (1, OPS_PHYS_SHADOW_REST))
    return _sum((events["rounds"], scan), (events["rounds"], OPS_HIT_REST),
                (hit_rounds, OPS_PHYS_HIT), (diffuse, OPS_PHYS_DIFFUSE),
                (max(hit_rounds - diffuse, 0), OPS_PHYS_MIRROR),
                (events["light_samples"], OPS_PHYS_LIGHT),
                (events["shadow_scans"], per_shadow))


def _on_basis(events: dict, nominal_rounds: int, basis: str) -> dict:
    """``executed``: the events as counted. ``nominal``: every thread runs
    every round, and each other event grows in proportion to the rounds."""
    if basis == "executed":
        return dict(events)
    if basis != "nominal":
        raise ValueError(f"basis must be 'executed' or 'nominal', not {basis!r}")
    scale = nominal_rounds / max(events["rounds"], 1)
    return {k: (nominal_rounds if k == "rounds" else v * scale) for k, v in events.items()}


def kernel_op_counts(kind: str, scene, height: int, width: int, spp: int, max_bounces: int,
                     events: dict, *, fwd_events: dict | None = None, n_em_cap: int = 0,
                     rough_grad: bool = False, basis: str = "executed") -> dict:
    """Per-class float32 operations of one render by one hand kernel, and
    the bytes it must move (each input read once, each output written once).

    ``kind``: ``forward`` (B1), ``fused`` (B2), ``physical`` (B3),
    ``physical_fused`` and ``physical_fused_geom`` (B4 without and with the
    sphere emitters' geometry planes, ``n_em_cap`` of them), ``physical_bwd``
    (B5, geometry with ``n_em_cap`` > 0). ``events``: what the kernel's own
    counting instantiation reported at this shape: ``{"rounds"}`` for B1 and
    B2 (``count_rounds``), B3's ``count_events`` dict, B4's ``count_events``
    (``rounds``, ``valid_samples``) for B4 and B5, which then also take B3's
    events at the same seed as ``fwd_events`` (the diffuse vertices, light
    samples and shadow scans of the same rounds). ``basis``: ``executed``
    (the events) or ``nominal`` (every thread runs ``max_bounces + 1``
    rounds a sample). Returns ``{"alu", "sqrt", "trig", "explog",
    "transcendental", "unknown", "bytes"}``.
    """
    if kind not in KINDS:
        raise ValueError(f"unknown kernel kind {kind!r}; one of {', '.join(KINDS)}")
    pix_spp = height * width * spp
    nominal = pix_spp * (max_bounces + 1)
    ev = _on_basis(events, nominal, basis)
    rounds = ev["rounds"]
    hit_rounds = max(rounds - pix_spp, 0)
    n_mat = scene.num_materials
    image = 12 * height * width
    if kind in ("forward", "fused"):
        scan = _sum((scene.num_spheres, OPS_SPHERE), (scene.num_triangles, OPS_TRIANGLE),
                    (1, OPS_HIT_REST))
        ops = _sum((rounds, scan), (hit_rounds, OPS_SHADE))
        nbytes = _reference_table_bytes(scene) + image
        if kind == "fused":
            ops = _sum((1, ops), (hit_rounds, OPS_SWEEP))
            nbytes += 4 * (9 * n_mat + 3) * height * width
    elif kind == "physical":
        ops = _physical_ops(scene, pix_spp, ev)
        nbytes = _physical_table_bytes(scene) + image
    else:
        if fwd_events is None:
            raise ValueError(f"kind {kind!r} needs the forward kernel's events (fwd_events)")
        fwd = _on_basis(fwd_events, nominal, basis)
        base = _physical_ops(scene, pix_spp, {**fwd, "rounds": rounds})
        valid = ev["valid_samples"]
        if kind == "physical_bwd":
            geo = _sum((1, OPS_CONE_ADJOINT), (1, OPS_PB_GEO)) if n_em_cap else _ops(0)
            ops = _sum((1, base), (hit_rounds, OPS_PB_SWEEP), (valid, OPS_PB_SWEEP_VALID),
                       (valid, geo))
            nbytes = (_physical_table_bytes(scene, 13) + image
                      + 4 * (8 * (n_mat + 1) + 4 * max(n_em_cap, 1)))
        else:
            geom = kind == "physical_fused_geom"
            geo = _sum((1, OPS_CONE_ADJOINT), (1, OPS_PF_GEO_PLANES)) if geom else _ops(0)
            ops = _sum((1, base), (hit_rounds, OPS_PF_SWEEP),
                       (hit_rounds if rough_grad else 0, OPS_PF_SWEEP_ROUGH),
                       (valid, OPS_PF_SWEEP_VALID), (valid, geo))
            n_planes = 9 * n_mat + 3 + (3 * n_mat if rough_grad else 0) + (12 * n_em_cap if geom else 0)
            nbytes = _physical_table_bytes(scene) + image + 4 * n_planes * height * width
    return {**ops, "transcendental": sum(ops[c] for c in _TRANSC), "unknown": 0,
            "bytes": nbytes}


def probe_op_counts(kind: str, height: int, width: int) -> dict:
    """Operations and bytes of the two probes at an image size: ``sol_null``
    (B7) stores 12 bytes a pixel and reads one float; ``sol_micro`` (B8)
    does ``MICRO_REPS x MICRO_NOBJ x 6`` operations a pixel, reads the table
    and the seed and stores 4 bytes a pixel."""
    pixels = height * width
    if kind == "sol_null":
        ops, nbytes = _ops(0), 12 * pixels + 4
    elif kind == "sol_micro":
        ops = _ops(6 * MICRO_REPS * MICRO_NOBJ * pixels)
        nbytes = 4 * pixels + 4 * 5 * MICRO_NOBJ + 4
    else:
        raise ValueError(f"unknown probe {kind!r}")
    return {**ops, "transcendental": 0, "unknown": 0, "bytes": nbytes}


def _larger(t_ops: float, t_bytes: float):
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def bound_ms(counts: dict):
    """The data-sheet bound of :func:`kernel_op_counts`' counts: every class
    at 67 TFLOP/s, the bytes at 3.35 TB/s, ``(ms, what bounds it)``."""
    return _larger(sum(counts[c] for c in CLASSES) / PEAK_FP32 * 1e3,
                   counts["bytes"] / PEAK_BYTES * 1e3)


def _ops_seconds(counts: dict, rates: dict) -> float:
    """Seconds to issue ``counts`` one after another at per-class ``rates``
    (a class with no operations needs no rate)."""
    return sum(counts[c] / rates[c] for c in CLASSES if counts[c])


def measured_bound_ms(counts: dict, rates: dict):
    """The bound at the card's measured ceiling: the larger of the operations
    over the per-class rates B6 measured and the bytes over 3.35 TB/s,
    ``(ms, what bounds it)``."""
    return _larger(_ops_seconds(counts, rates) * 1e3, counts["bytes"] / PEAK_BYTES * 1e3)


# -- count_ops: the aten operations a call dispatches --------------------------

# Elementwise operations, one per output element: arithmetic, compares,
# selects, bit operations, min/max of two tensors.
_ALU = {
    "add", "sub", "rsub", "mul", "div", "remainder", "fmod", "floor_divide", "neg", "abs",
    "sign", "sgn", "floor", "ceil", "round", "trunc", "frac", "reciprocal", "square",
    "maximum", "minimum", "fmax", "fmin", "clamp", "clamp_min", "clamp_max", "where",
    "masked_fill", "eq", "ne", "ge", "gt", "le", "lt", "isfinite", "isinf", "isnan",
    "logical_and", "logical_or", "logical_xor", "logical_not", "bitwise_and", "bitwise_or",
    "bitwise_xor", "bitwise_not", "bitwise_left_shift", "bitwise_right_shift",
    "__and__", "__or__", "__xor__", "__lshift__", "__rshift__", "lerp", "addcmul", "addcdiv",
    "copysign", "nextafter", "linalg_cross",
}
_SQRT = {"sqrt", "rsqrt"}
_TRIG = {"sin", "cos", "tan", "atan", "atan2", "asin", "acos", "sinh", "cosh"}
_EXPLOG = {"log", "log1p", "log2", "log10", "exp", "exp2", "expm1", "pow", "tanh",
           "sigmoid", "erf", "erfc"}
# Reductions, one operation per input element.
_REDUCE = {"sum", "prod", "mean", "amax", "amin", "any", "all", "argmax", "argmin",
           "aminmax", "kthvalue", "median", "logsumexp", "norm", "linalg_vector_norm"}
# Data movement, layout and bookkeeping: no arithmetic.
_FREE = {
    "view", "_unsafe_view", "reshape", "expand", "expand_as", "permute", "transpose", "t",
    "squeeze", "unsqueeze", "select", "slice", "narrow", "diagonal", "movedim", "flatten",
    "unflatten", "unbind", "split", "split_with_sizes", "chunk", "as_strided", "alias",
    "index", "index_select", "gather", "take", "cat", "stack", "clone", "copy", "_to_copy",
    "to", "detach", "lift_fresh", "lift_fresh_copy", "contiguous", "empty", "empty_like",
    "empty_strided", "new_empty", "new_empty_strided", "zeros", "zeros_like", "ones",
    "ones_like", "full", "full_like", "new_zeros", "new_ones", "new_full", "scalar_tensor",
    "arange", "_local_scalar_dense", "fill", "zero", "resize", "cumsum", "searchsorted",
    "sort", "scatter", "scatter_add", "index_put", "index_add", "constant_pad_nd", "repeat",
    "roll", "flip", "nonzero", "masked_select", "_to_dense", "_to_copy", "set",
    "is_nonzero", "equal", "result_type", "sym_size", "sym_numel", "sym_stride",
}


def _op_name(func) -> str:
    name = func.overloadpacket.__name__
    if name.endswith("_") and not name.endswith("__"):
        name = name[:-1]  # in place: mul_ counts as mul
    return name


def _classify(func, args, kwargs) -> str:
    """``alu``, ``sqrt``, ``trig``, ``explog``, ``reduce``, ``free`` or
    ``unknown``."""
    name = _op_name(func)
    if name in ("max", "min"):  # of one tensor (a reduction) or of two
        two = func._overloadname in ("other", "binary", "out")
        return "alu" if two else "reduce"
    if name == "pow" and any(isinstance(a, (int, float)) and float(a).is_integer()
                             and 0 <= a <= 4 for a in args[1:2]):
        return "alu"  # a small integer power is a few multiplies (integer_pow)
    for cls, table in (("alu", _ALU), ("sqrt", _SQRT), ("trig", _TRIG),
                       ("explog", _EXPLOG), ("reduce", _REDUCE), ("free", _FREE)):
        if name in table:
            return cls
    return "unknown"


class _OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {"alu": 0.0, "transcendental": 0.0, "unknown": 0.0,
                       "sqrt": 0.0, "trig": 0.0, "explog": 0.0}
        self.unknown = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        cls = _classify(func, args, kwargs)
        if cls == "free":
            return out
        if cls == "reduce":
            self.counts["alu"] += sum(t.numel() for t in tree_leaves(args[:1])
                                      if isinstance(t, torch.Tensor))
            return out
        size = max((t.numel() for t in tree_leaves(out) if isinstance(t, torch.Tensor)),
                   default=0)
        if cls == "alu":
            self.counts["alu"] += size
        elif cls == "unknown":
            self.counts["unknown"] += size
            self.unknown.add(_op_name(func))
        else:
            self.counts[cls] += size
            self.counts["transcendental"] += size
        return out


def count_ops(fn, *args, **kwargs) -> dict:
    """Operation counts of ``fn(*args, **kwargs)`` as it runs, by class.

    The counterpart of the JAX package's jaxpr walker: every aten operation
    the call dispatches is classified (``torch.utils._python_dispatch``).
    Elementwise operations count one per output element, reductions one per
    input element, views, copies and tensor creation nothing. PyTorch runs
    eagerly, so loops count the trips they took. ``unknown_prims`` names the
    operations the table does not know (their output elements are in
    ``unknown``): keep it empty for a function whose counts are reported.
    """
    mode = _OpCounter()
    with mode:
        fn(*args, **kwargs)
    return {**mode.counts, "unknown_prims": sorted(mode.unknown)}


# -- B6: the op-rate calibration kernel ---------------------------------------

CALIB_UNROLL = 16
_CALIB_KIND_ID = {"alu": 0, "sqrt": 1, "trig": 2, "explog": 3}
# A round of each chain: (operations of the measured class, ALU operations
# beside them). alu: two dependent multiply-adds, four operations under
# -fmad=false; sqrt: sqrt(v + 1.5); trig: cos(v); explog: log1p(|v| * 0.5).
_CALIB_ROUND = {"alu": (4, 0), "sqrt": (1, 1), "trig": (1, 0), "explog": (1, 2)}
# Rounds (of CALIB_UNROLL steps) a thread runs at a full launch, chosen so
# one launch takes 10-40 ms on an H100: cheap classes get more.
CALIB_REPS = {"alu": 1 << 15, "sqrt": 1 << 14, "explog": 1 << 13, "trig": 1 << 12}
_A1, _B1 = _f32(1.000000119), _f32(1e-7)
_A2, _B2 = _f32(0.999999881), _f32(-1e-7)


def calib_ops(kind: str, reps: int, threads: int) -> dict:
    """Per-class operations of one calibration launch."""
    measured, alu = _CALIB_ROUND[kind]
    steps = threads * reps * CALIB_UNROLL
    ops = _ops(steps * (measured if kind == "alu" else alu))
    if kind != "alu":
        ops[kind] = steps * measured
    return {**ops, "transcendental": sum(ops[c] for c in _TRANSC), "unknown": 0,
            "bytes": 8 * threads}


def _check_kind(kind: str):
    if kind not in _CALIB_KIND_ID:
        raise ValueError(f"calibration kind must be one of {', '.join(_CALIB_KIND_ID)}, not {kind!r}")


def calib_reference(kind: str, reps: int, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of B6: ``reps * CALIB_UNROLL`` dependent steps of
    ``kind``'s chain on every element of the float32 tensor ``x``, on its
    device. Roots are correctly rounded (``sqrt_rn``), as ``sqrtf`` is."""
    _check_kind(kind)
    v = x.to(torch.float32)
    for _ in range(reps * CALIB_UNROLL):
        if kind == "alu":
            a = v * _A1 + _B1
            v = a * _A2 + _B2
        elif kind == "sqrt":
            v = sqrt_rn(v + 1.5)
        elif kind == "trig":
            v = torch.cos(v)
        else:
            v = torch.log1p(torch.abs(v) * 0.5)
    return v


def calib_kernel(kind: str, reps: int, x: torch.Tensor) -> torch.Tensor:
    """B6 on a contiguous 1-D float32 tensor: one thread an element, each
    running ``reps * CALIB_UNROLL`` dependent steps of ``kind``'s chain; the
    result of every element. CUDA tensors launch ``csrc/calib.cu``
    (the counter ``launch.calib`` counts them); CPU tensors run
    ``calib_reference``. Any other device raises."""
    _check_kind(kind)
    if reps < 0:
        raise ValueError(f"reps {reps} < 0")
    if x.dtype != torch.float32 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError("calib_kernel takes a contiguous 1-D float32 tensor")
    if x.device.type == "cpu":
        return calib_reference(kind, reps, x)
    if x.device.type != "cuda":
        raise ValueError(f"calib_kernel runs on CUDA or CPU tensors, not {x.device}")
    from ..ops.build import load_library

    lib = load_library()
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.calib(ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(out.data_ptr()), x.numel(),
                    _CALIB_KIND_ID[kind], int(reps), x.device.index, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"calib kernel launch failed: CUDA error {err}")
    tracing.count("launch.calib")
    return out


def _cuda_device(device) -> torch.device:
    device = torch.device(device if device is not None else "cuda")
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"measuring an op rate needs a CUDA device, not {device}")
    return torch.device("cuda", torch.cuda.current_device() if device.index is None else device.index)


def default_threads(device=None) -> int:
    """The calibration's launch size: 2048 threads (the most a Hopper SM
    holds) on every SM of the card."""
    props = torch.cuda.get_device_properties(_cuda_device(device))
    return props.multi_processor_count * 2048


def measure_op_rate(kind: str = "alu", reps: int | None = None, iters: int = 5,
                    alu_rate: float | None = None, with_spread: bool = False, device=None,
                    threads: int | None = None):
    """Sustained operations a second of one class on the card, launch cost
    removed.

    Times B6 by CUDA events at ``reps`` and ``2 * reps`` (default
    ``CALIB_REPS[kind]``) on ``threads`` threads (default: 2048 on every
    SM), ``iters`` times each after a warm launch, and takes the rate from
    the difference of the two times, which cancels the fixed cost of a
    launch. The primary rate comes from the two minima (timing noise only
    adds time). For the non-ALU kinds, ``alu_rate`` (measured with
    ``kind="alu"``) removes the round's ALU operations; without it they stay
    in and the rate is understated, never overstated. ``with_spread=True``
    returns ``(rate, samples)``, the rates of the ``iters`` pairs. Raises
    without a CUDA device."""
    _check_kind(kind)
    device = _cuda_device(device)
    reps = CALIB_REPS[kind] if reps is None else reps
    threads = default_threads(device) if threads is None else threads
    salt = [0]

    def timed(r):
        def run():
            salt[0] += 1
            x = torch.full((threads,), 1.0 + salt[0] * 1e-6, dtype=torch.float32, device=device)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            calib_kernel(kind, r, x)
            end.record()
            torch.cuda.synchronize(device)
            return start.elapsed_time(end) * 1e-3

        run()
        return [run() for _ in range(iters)]

    t1s = timed(reps)
    t2s = timed(2 * reps)
    measured, alu_per_round = _CALIB_ROUND[kind]
    steps = threads * reps * CALIB_UNROLL

    def to_rate(dt):
        dt = max(dt, 1e-9)
        if alu_per_round and alu_rate:
            dt = max(dt - steps * alu_per_round / alu_rate, 1e-9)
        return steps * measured / dt

    rate = to_rate(min(t2s) - min(t1s))
    if with_spread:
        return rate, [to_rate(b - a) for a, b in zip(t1s, t2s)]
    return rate


def measure_op_rates(device=None, with_spread: bool = False, iters: int = 5):
    """The four class rates: ALU first, then the others with the ALU rate
    removed. With ``with_spread``, ``(rates, samples by class)``."""
    alu = measure_op_rate("alu", iters=iters, with_spread=with_spread, device=device)
    alu_rate = alu[0] if with_spread else alu
    out = {"alu": alu}
    for cls in _TRANSC:
        out[cls] = measure_op_rate(cls, iters=iters, alu_rate=alu_rate,
                                   with_spread=with_spread, device=device)
    if with_spread:
        return {c: v[0] for c, v in out.items()}, {c: v[1] for c, v in out.items()}
    return out


# The launch-shape kinds (ops/render_kernel.KINDS) of KINDS.
_TILE_KINDS = {"forward": "fwd", "fused": "fused", "physical": "phys",
               "physical_fused": "phys_fused", "physical_fused_geom": "phys_fused",
               "physical_bwd": "phys_bwd"}


def sol_report(kind: str, scene, height: int, width: int, spp: int, max_bounces: int,
               measured_seconds: float, events: dict, *, fwd_events: dict | None = None,
               n_em_cap: int = 0, rough_grad: bool = False, basis: str = "executed",
               alu_rate: float | None = None, transc_rate=None, device=None,
               tile=None) -> dict:
    """Measured speed-of-light report of one render by one hand kernel.

    ``measured_seconds`` is the render's timed device time; ``kind``,
    ``events`` and the rest select the counts (:func:`kernel_op_counts`).
    ``tile``: the launch shape the time was measured at (the point
    ``ops/render_kernel.fit_tile`` gives it, the default where it is None),
    reported as ``tile``; the counts do not depend on it.
    ``alu_rate`` and ``transc_rate`` (a dict by class, or one blended rate)
    default to a fresh calibration on the card. ``sol_seconds`` issues every
    counted operation one after another at its class's measured rate, the
    model the calibration measures."""
    counts = kernel_op_counts(kind, scene, height, width, spp, max_bounces, events,
                              fwd_events=fwd_events, n_em_cap=n_em_cap, rough_grad=rough_grad,
                              basis=basis)
    if alu_rate is None:
        alu_rate = measure_op_rate("alu", device=device)
    if transc_rate is None:
        transc_rate = {cls: measure_op_rate(cls, alu_rate=alu_rate, device=device)
                       for cls in _TRANSC}
    if not isinstance(transc_rate, dict):
        transc_rate = {cls: transc_rate for cls in _TRANSC}
    sol_seconds = _ops_seconds(counts, {"alu": alu_rate, **transc_rate})
    launch = rk.fit_tile(_TILE_KINDS[kind], scene, height, width, max_bounces, tile,
                         n_em_cap=n_em_cap)
    return {
        "tile": launch.name,
        "alu_ops": counts["alu"],
        "transcendental_ops": counts["transcendental"],
        "sqrt_ops": counts["sqrt"],
        "trig_ops": counts["trig"],
        "explog_ops": counts["explog"],
        "unknown_ops": counts["unknown"],
        "unknown_prims": [],
        "measured_alu_ops_per_sec": alu_rate,
        "measured_transc_ops_per_sec": transc_rate,
        "sustained_alu_ops_per_sec": counts["alu"] / measured_seconds,
        "sol_seconds": sol_seconds,
        "sol_fraction": sol_seconds / measured_seconds,
    }
