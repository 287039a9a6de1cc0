"""The port's ``physics`` package against the JAX package's, in float64 (the
JAX side under the ``_x64`` context of tests/test_physics.py), on three
systems: the Kepler two-body orbit, the Earth-Sun-Moon preset in AU / M_sun
/ day (cast to float64 on both sides) and the 100-body Plummer sphere
``examples/nbody/pl100.txt``. Both sides start from the same numpy arrays.

Tolerance: rtol=1e-12, atol=1e-14 (float64; the two sides sum over bodies
in another order, which moves a few-step trajectory by some 1e-16 relative),
looser where a quantity differences nearly equal values (stated there),
and ``num_valid`` of the adaptive drivers exactly equal.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physicsbasedbayesianinference_tpu import physics as jph
from physicsbasedbayesianinference_tpu.constants import (
    NATURAL as J_NATURAL, solar_system_units as j_astro)
from physicsbasedbayesianinference_tpu_torch import physics as tph
from physicsbasedbayesianinference_tpu_torch.constants import (
    NATURAL, solar_system_units)
from physicsbasedbayesianinference_tpu_torch.ops import kernels
from physicsbasedbayesianinference_tpu_torch.ops import potentials as tp
from physicsbasedbayesianinference_tpu_torch.utils import convert
from _torch_cpu import cpu_requested  # noqa: F401  (the CPU, asked for)

TOL = dict(rtol=1e-12, atol=1e-14)
PL100 = os.path.join(os.path.dirname(__file__), "..", "examples", "nbody",
                     "pl100.txt")
SYSTEMS = ["kepler", "solar_astro", "pl100"]
# (dt, softening) per system: a few steps of each at its own scale
SETTINGS = {"kepler": (0.01, 0.0), "solar_astro": (0.5, 0.0),
            "pl100": (0.001, 0.01)}


@pytest.fixture(autouse=True)
def _x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


def _numpy(system) -> dict:
    return {k: np.asarray(getattr(system, k), np.float64)
            for k in ("x", "v", "mass", "time")}


def _systems(name):
    """(JAX system, port system, JAX constants, port constants)."""
    if name == "kepler":
        j, _ = jph.kepler_two_body(eccentricity=0.5, dtype=jnp.float64)
        jc, tc = J_NATURAL, NATURAL
    elif name == "solar_astro":
        j32, _ = jph.solar_system("astro")
        j = jph.new_system(*(np.asarray(getattr(j32, k), np.float64)
                             for k in ("x", "v", "mass")),
                           dtype=jnp.float64)
        jc, tc = j_astro(), solar_system_units()
    else:
        j, _, _ = jph.load_nbody_text(PL100)
        jc, tc = J_NATURAL, NATURAL
    return j, convert.nbody_system_from_numpy(_numpy(j)), jc, tc


def _close(t, j, **tol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **(tol or TOL))


METHODS = sorted(jph.PHYSICS_INTEGRATORS) + ["hermite"]


@pytest.mark.parametrize("name", SYSTEMS)
@pytest.mark.parametrize("method", METHODS)
def test_zoo_steps_match_jax(name, method):
    j, t, jc, tc = _systems(name)
    dt, soft = SETTINGS[name]
    js, ts = jph.get_physics_integrator(method), \
        tph.get_physics_integrator(method)

    def ja(x):
        return jph.accelerations(j.replace(x=x), constants=jc,
                                 softening=soft)

    def ta(x):
        return tph.accelerations(t.replace(x=x), constants=tc,
                                 softening=soft)

    extra_j, extra_t = (), ()
    if method in jph.integrators.NEEDS_JERK:
        extra_j = (lambda x, v: jph.jerk(x, v, j.mass, constants=jc,
                                         softening=soft),)
        extra_t = (lambda x, v: tph.jerk(x, v, t.mass, constants=tc,
                                         softening=soft),)
    jx, jv, tx, tv = j.x, j.v, t.x, t.v
    jdt, tdt = jnp.asarray(dt, jnp.float64), torch.tensor(dt,
                                                          dtype=torch.float64)
    for _ in range(3):
        jx, jv = js(ja, *extra_j, jx, jv, jdt)
        tx, tv = ts(ta, *extra_t, tx, tv, tdt)
    _close(tx, jx)
    _close(tv, jv)


@pytest.mark.parametrize("name", SYSTEMS)
def test_conserved_quantities_and_jerk_match_jax(name):
    j, t, jc, tc = _systems(name)
    soft = SETTINGS[name][1]
    _close(tph.total_energy(t, constants=tc, softening=soft),
           jph.total_energy(j, constants=jc, softening=soft))
    _close(tph.total_angular_momentum(t), jph.total_angular_momentum(j))
    _close(tph.jerk(t.x, t.v, t.mass, constants=tc, softening=soft),
           jph.jerk(j.x, j.v, j.mass, constants=jc, softening=soft))
    inv_t = tph.two_body_invariants(t, constants=tc)
    inv_j = jph.two_body_invariants(j, constants=jc)
    for key in inv_j:
        _close(inv_t[key], inv_j[key])
    _close(tph.center_of_mass_frame(t).x, jph.center_of_mass_frame(j).x)
    _close(tph.adaptive_dt_simple(t, 0.05, constants=tc, softening=soft),
           jph.adaptive_dt_simple(j, 0.05, constants=jc, softening=soft))
    # the advanced criterion differences a(x) and a(x + dt0 v + ...), which
    # agree to ~1e-4 relative over dt0: rounding grows by that cancellation
    _close(tph.adaptive_dt_advanced(t, 0.05, constants=tc, softening=soft),
           jph.adaptive_dt_advanced(j, 0.05, constants=jc, softening=soft),
           rtol=1e-9)


def test_blocked_energy_matches_one_block(monkeypatch):
    """Above the block size the pairwise energy runs over row blocks; the
    same sum in another order."""
    _, t, _, tc = _systems("pl100")
    whole = tph.total_energy(t, constants=tc, softening=0.01)
    monkeypatch.setattr(tp, "_ENERGY_PAIR_BLOCK", 700)  # 7 rows
    _close(tph.total_energy(t, constants=tc, softening=0.01), whole)


@pytest.mark.parametrize("name", SYSTEMS)
@pytest.mark.parametrize("method", ["velocity_verlet", "hermite"])
def test_simulate_matches_jax(name, method):
    j, t, jc, tc = _systems(name)
    dt, soft = SETTINGS[name]
    jt = jph.simulate(j, dt, 6, method=method, save_every=2, constants=jc,
                      softening=soft)
    tt = tph.simulate(t, dt, 6, method=method, save_every=2, constants=tc,
                      softening=soft)
    assert tt.num_valid == int(jt.num_valid) == 3
    for key in ("x", "v", "times", "energy", "angular_momentum",
                "initial_energy"):
        _close(getattr(tt, key), getattr(jt, key))
    _close(tt.final.x, jt.final.x)
    _close(tt.final.time, jt.final.time)
    # a relative difference of nearly equal energies: its rounding is that
    # of E itself, some 1e-16 absolute
    _close(tph.energy_drift(tt), jph.energy_drift(jt), rtol=1e-9,
           atol=1e-14)
    with pytest.raises(ValueError, match="divisible"):
        tph.simulate(t, dt, 5, save_every=2)


@pytest.mark.parametrize("method,criterion", [
    ("velocity_verlet", "simple"), ("hermite", "advanced")])
def test_simulate_adaptive_matches_jax(method, criterion):
    j, t, jc, tc = _systems("kepler")
    kw = dict(method=method, criterion=criterion, max_steps=64)
    jt = jph.simulate_adaptive(j, 0.05, 0.5, constants=jc, **kw)
    tt = tph.simulate_adaptive(t, 0.05, 0.5, constants=tc, **kw)
    n = int(jt.num_valid)
    assert 0 < tt.num_valid == n < 64
    for key in ("x", "v", "times", "energy", "angular_momentum"):
        _close(getattr(tt, key), getattr(jt, key))
    _close(tt.final.time, jt.final.time)
    # a buffer too short to reach the final time stops at max_steps
    short = tph.simulate_adaptive(t, 0.05, 0.5, constants=tc,
                                  **{**kw, "max_steps": 4})
    assert short.num_valid == int(jph.simulate_adaptive(
        j, 0.05, 0.5, constants=jc, **{**kw, "max_steps": 4}).num_valid) \
        == 4


def test_simulate_rk45_matches_jax():
    """A first step too long for the tolerance: the controller rejects and
    retries, so the dummy-slot path runs."""
    j, t, jc, tc = _systems("kepler")
    kw = dict(rtol=1e-8, atol=1e-10, max_steps=64)
    jt = jph.simulate_rk45(j, 0.5, 1.0, constants=jc, **kw)
    tt = tph.simulate_rk45(t, 0.5, 1.0, constants=tc, **kw)
    n = int(jt.num_valid)
    assert 0 < tt.num_valid == n < 64
    for key in ("x", "v", "times", "energy", "angular_momentum"):
        _close(getattr(tt, key), getattr(jt, key), rtol=1e-10, atol=1e-12)
    _close(tt.final.time, jt.final.time)


def test_text_io_roundtrips_against_jax():
    j, _, _ = jph.load_nbody_text(PL100)
    t, tmax, dt = tph.load_nbody_text(PL100)
    assert (t.x.dtype, t.num_bodies, t.num_space_dims) == (torch.float64,
                                                           100, 3)
    for key in ("x", "v", "mass"):
        np.testing.assert_array_equal(getattr(t, key).numpy(),
                                      np.asarray(getattr(j, key)))
    text = tph.save_nbody_text(t, tmax, dt)
    assert text == jph.save_nbody_text(j, tmax, dt)
    back, tmax2, dt2 = tph.load_nbody_text(text)
    assert torch.equal(back.x, t.x) and (tmax2, dt2) == (tmax, dt)
    t32, _, _ = tph.load_nbody_text(text, dtype=torch.float32)
    assert t32.mass.dtype == torch.float32
    with pytest.raises(ValueError, match="truncated"):
        tph.load_nbody_text("3 1.0 0.1\n0.5\n")


def test_presets_match_jax():
    for units in ("si", "astro"):
        js, jc = jph.solar_system(units)
        ts, tc = tph.solar_system(units)
        assert ts.x.dtype == {"si": torch.float64,
                              "astro": torch.float32}[units]
        np.testing.assert_array_equal(ts.x.numpy(), np.asarray(js.x))
        np.testing.assert_array_equal(ts.mass.numpy(), np.asarray(js.mass))
        assert tc.G == pytest.approx(jc.G, rel=1e-15)
    with pytest.raises(ValueError, match="units"):
        tph.solar_system("cgs")


def test_nbody_system_from_numpy_copies_exactly():
    j, _, _, _ = _systems("pl100")
    arrays = {k: np.array(v) for k, v in _numpy(j).items()}  # writable
    t = convert.nbody_system_from_numpy(arrays)
    for key, arr in arrays.items():
        np.testing.assert_array_equal(getattr(t, key).numpy(), arr)
        assert getattr(t, key).dtype == torch.float64
    arrays["x"][0, 0] += 1.0  # the port's tensor is a copy, not a view
    assert t.x[0, 0].item() != arrays["x"][0, 0]
    with pytest.raises(KeyError, match="time"):
        convert.nbody_system_from_numpy({"x": arrays["x"],
                                         "v": arrays["v"],
                                         "mass": arrays["mass"]})


def test_cpu_accelerations_take_the_plain_route():
    """A CPU state (and a batched one) runs the plain pairwise form; kernel
    E's counter does not move."""
    _, t, _, tc = _systems("pl100")
    before = kernels.launch_counts()
    a = tph.accelerations(t, constants=tc, softening=0.01)
    assert torch.equal(a, tp.nbody_accelerations(t.x, t.mass, softening=0.01))
    batched = t.replace(x=torch.stack([t.x, 2.0 * t.x]))
    b = tph.accelerations(batched, constants=tc, softening=0.01)
    assert b.shape == (2, 100, 3)
    assert torch.equal(b[0], a)
    assert kernels.launch_counts() == before


def test_native_and_numpy_tokenizers_agree(monkeypatch):
    """The compiled parser (where the host has a C++ compiler) and the numpy
    tokenizer read the same file to the same float64 arrays."""
    from physicsbasedbayesianinference_tpu_torch import native
    with open(PL100) as f:
        text = f.read()
    first = native.parse_nbody_text(text)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    second = native.parse_nbody_text(text)
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="truncated"):
        native.parse_nbody_text("3 1.0")
