"""PyTorch port: the PCG stream and its samplers against the JAX package.

The RNG is the numeric contract shared by every implementation, so every
comparison here is bit-exact, on states made with numpy that include
values >= 2^31.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from path_tracer_c_tpu.ops import rng as jrng
from path_tracer_c_tpu_torch.ops import rng as trng

torch.set_num_threads(1)


def _states(seed, n=4096):
    s = np.random.default_rng(seed).integers(0, 2**32, size=n, dtype=np.uint64)
    s[:4] = [0, 2**31 - 1, 2**31, 2**32 - 1]
    return s.astype(np.uint32)


def _t(states):
    return torch.from_numpy(states.astype(np.int64))


def test_pcg_stream_bit_exact():
    states = _states(0)
    js, ts = jnp.asarray(states), _t(states)
    for _ in range(8):
        js, jb = jrng.pcg_next(js)
        ts, tb = trng.pcg_next(ts)
        np.testing.assert_array_equal(np.asarray(js, np.int64), ts.numpy())
        np.testing.assert_array_equal(np.asarray(jb, np.int64), tb.numpy())
    assert ts.min() >= 0 and ts.max() < 2**32


def test_uniform_bit_exact():
    states = _states(1)
    js, ju = jrng.uniform(jnp.asarray(states))
    ts, tu = trng.uniform(_t(states))
    assert tu.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(js, np.int64), ts.numpy())
    np.testing.assert_array_equal(np.asarray(ju), tu.numpy())
    assert 0.0 <= tu.min() and tu.max() <= 1.0


def test_unit_sphere_bit_exact_and_two_draws():
    states = _states(2)
    js, jv = jrng.unit_sphere(jnp.asarray(states))
    ts, tv = trng.unit_sphere(_t(states))
    np.testing.assert_array_equal(np.asarray(js, np.int64), ts.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    # 2 draws: the same state as two PCG steps
    s2, _ = trng.pcg_next(trng.pcg_next(_t(states))[0])
    np.testing.assert_array_equal(s2.numpy(), ts.numpy())


@pytest.mark.parametrize("kind", ["random", "grid"])
def test_sincos_2pi_bit_exact(kind):
    if kind == "random":
        u = np.random.default_rng(3).random(8192, dtype=np.float32)
    else:  # every quadrant boundary and its neighbours
        u = np.linspace(0.0, 1.0, 4097, dtype=np.float32)
    jc, js = jrng.sincos_2pi(jnp.asarray(u))
    tc, ts = trng.sincos_2pi(torch.from_numpy(u))
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())


@pytest.mark.parametrize("sample, seed", [(0, 0), (7, 12345), (2**20 + 3, 2**32 - 1)])
def test_seed_state_bit_exact(sample, seed):
    rng = np.random.default_rng(4)
    pix = np.concatenate([np.arange(1024), rng.integers(0, 2**31, 1024)]).astype(np.int32)
    j = jrng.seed_state(jnp.asarray(pix), jnp.int32(sample), jnp.uint32(seed))
    t = trng.seed_state(torch.from_numpy(pix.astype(np.int64)), sample, seed)
    np.testing.assert_array_equal(np.asarray(j, np.int64), t.numpy())


@pytest.mark.parametrize("name, draws", [
    ("normal", 2), ("unit_sphere_gaussian", 6), ("unit_sphere_biased", 3)])
def test_other_samplers_bit_exact(name, draws):
    """Box-Muller and the two unit-sphere samplers of the JAX package,
    states and values bit for bit; each consumes its fixed draws."""
    states = _states(5, n=65536)
    js, jv = getattr(jrng, name)(jnp.asarray(states))
    ts, tv = getattr(trng, name)(_t(states))
    assert tv.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(js, np.int64), ts.numpy())
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    s = _t(states)
    for _ in range(draws):
        s, _ = trng.pcg_next(s)
    np.testing.assert_array_equal(s.numpy(), ts.numpy())
    if name != "normal":
        np.testing.assert_allclose(np.linalg.norm(tv.numpy(), axis=-1), 1.0, atol=1e-6)


def test_log_and_cos_bit_exact():
    """The float32 log and cos these samplers take, against jnp.log and
    jnp.cos on the CPU, over uniforms, the edge cases and the angles
    2 pi u (cos covers |x| < 120 and refuses more). The reference is one
    XLA build's CPU code: transcribed from jaxlib 0.9.0 on an x86-64 host
    with FMA (XLA's Cephes-style log with fused multiply-adds; glibc's
    cosf). Another jaxlib or host may round these differently; the
    assertion names the build and host it ran on. The edge cases give NaN,
    so JAX's ``jax_debug_nans`` is held off (the JAX CLI's ``--debug-nans``
    turns it on for the rest of the process it runs in)."""
    import platform

    import jax

    where = f"jax {jax.__version__}, jaxlib {jax.lib.__version__}, {platform.machine()}"
    rng = np.random.default_rng(6)
    u = (rng.integers(0, 2**32, 200000, dtype=np.uint64).astype(np.float32)
         * np.float32(1 / 4294967295.0))
    edges = np.array([0.0, 1e-38, 1.2e-38, 1e-30, 0.5, 0.70710677, 1.0, 2.0, 97.5,
                      np.inf, -1.0, np.nan], np.float32)
    x = np.concatenate([u, edges, rng.random(20000, dtype=np.float32) * 100])
    with jax.debug_nans(False):
        j_log = np.asarray(jnp.log(x))
    np.testing.assert_array_equal(j_log, trng.log_f32(torch.from_numpy(x)).numpy(),
                                  err_msg=f"log_f32 against jnp.log on {where}")
    th = np.concatenate([np.float32(6.2831855) * u, -u * 50, [0.0, 2.4e-4, 0.7853982, 119.9]])
    th = th.astype(np.float32)
    with jax.debug_nans(False):
        j_cos = np.asarray(jnp.cos(th))
    np.testing.assert_array_equal(j_cos, trng.cos_f32(torch.from_numpy(th)).numpy(),
                                  err_msg=f"cos_f32 against jnp.cos on {where}")
    with pytest.raises(ValueError):
        trng.cos_f32(torch.tensor([120.0]))
