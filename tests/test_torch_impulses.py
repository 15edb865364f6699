"""The five impulses and the per-frame prologue
(sph_tpu_torch.physics.impulses, sph_tpu_torch.app.configs.frame_prologue)
against ``sph_tpu`` (the curl noise bit for bit against the JAX functions
run op by op), and the ``rotated_512k`` path at a small size: a rotated
box, the wave before every frame and the emitted-row transport, against
the JAX all-pairs oracle.

The JAX reference density of a wave configuration at full size (the
constants in ``chip_smoke.REF_RHO``) is printed by

    PYTHONPATH=. python tests/test_torch_impulses.py rotated_512k 4 16 16

(config, frames, substeps per frame, binned cell capacity): ``sph_tpu``
``binned`` on the CPU, with the largest cell occupancy seen before any
substep, so that a capacity the fluid outgrows is visible.
"""
import dataclasses
import sys

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU ops on one thread while this module runs: the suite
    runs in several processes at once, where each process's pool of torch
    threads spins against the others'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# tests/test_brute_pallas.py:40-42
POS_TOL, VEL_TOL, RHO_TOL = 1e-4, 1e-3, 1.0
# the wave's kick: |A| <= 1 and theta = k p.d + phase is about 30 at
# |p| = 20, where float32 rounds theta by ~2e-6 (the order of the dot
# product differs between the frameworks)
WAVE_ATOL = 1e-5

# a small rotated_512k: the same box rotation, local spawn and wave, 2048
# targeted rows in a box of half (2, 3, 2): the spawn fills 40% of its
# height with 1,960 of them
ROTATED_SMALL = dict(name="rotated_2k", n_target=2048,
                     box_half=(2.0, 3.0, 2.0), box_euler_deg=(20.0, 0.0, 30.0),
                     wave_impulse=True, spawn_rotation="local")


def to_numpy(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def shell_state_numpy(seed=4):
    """512 fluid rows inside a ghost shell, padded, with random velocities
    (a numpy dict of the state's fields) and its params."""
    from sph_tpu.core import params as JP
    from sph_tpu.core import state as JS
    half = (3.0, 3.0, 3.0)
    spawn = JS.concat_spawns(JS.spawn_standard(500, box_half=half, seed=1),
                             JS.spawn_ghost_box_shell(box_half=half))
    d = to_numpy(JS.state_from_spawn(spawn))
    assert (d["valid"] == 0).sum() > 0 and (d["ghost"] > 0).sum() > 0
    rng = np.random.default_rng(seed)
    d["vel"] = rng.standard_normal(d["vel"].shape).astype(np.float32)
    d["pos"] = d["pos"] + np.float32(10.0) * np.asarray(
        [1.0, 0.0, -1.0], np.float32)           # |p| up to ~20
    params = JP.FluidParams.default(
        box_half=np.asarray(half, np.float32)).derive_mass()
    return d, params


def jax_state(d):
    import jax.numpy as jnp
    from sph_tpu.core.state import ParticleState
    return ParticleState(**{k: jnp.asarray(v) for k, v in d.items()})


WAVES = {
    "bench": dict(amplitude=0.96, wavelength=4.0, phase=0.7,
                  direction=(1.0, 0.0, 0.3)),
    "y_band": dict(amplitude=-2.5, wavelength=1.3, phase=0.0,
                   direction=(0.0, 2.0, -1.0), y_min=-1.0, y_max=1.5),
    "no_direction": dict(amplitude=0.5, wavelength=3.0, phase=1.0,
                         direction=(0.0, 0.0, 0.0)),
    "zero_amplitude": dict(amplitude=0.0, wavelength=3.0, phase=1.0,
                           direction=(1.0, 1.0, 1.0)),
    "no_wavelength": dict(amplitude=1.0, wavelength=0.0, phase=1.0,
                          direction=(1.0, 1.0, 1.0)),
}


@pytest.mark.parametrize("wave", list(WAVES))
def test_wave_impulse_matches_jax(wave):
    from sph_tpu.physics.impulses import wave_impulse as jax_wave
    from sph_tpu_torch.core.convert import state_from_numpy
    from sph_tpu_torch.physics.impulses import wave_impulse

    d, _ = shell_state_numpy()
    kw = dict(WAVES[wave])
    want = np.asarray(jax_wave(jax_state(d), **kw).vel)
    got = wave_impulse(state_from_numpy(d, device="cpu"), **kw).vel.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=WAVE_ATOL)
    # ghosts, padding and rows outside the y band keep their velocity
    y = d["pos"][:, 1]
    still = ((d["ghost"] > 0) | (d["valid"] == 0)
             | (y < kw.get("y_min", -np.inf)) | (y > kw.get("y_max", np.inf)))
    np.testing.assert_array_equal(got[still], d["vel"][still])
    moved = int((got != d["vel"]).any(axis=1).sum())
    if wave in ("zero_amplitude", "no_wavelength"):
        assert moved == 0
    else:
        assert moved > 50 and still.sum() > 100


@pytest.mark.parametrize("n_substeps", [16, 5])
def test_frame_prologue_is_the_bench_prologue(n_substeps):
    """``configs.frame_prologue`` is ``bench.py:79-88``: for a wave
    configuration the wave with amplitude 60 dt n_substeps, wavelength 4,
    phase 0.7 and direction (1, 0, 0.3); for the others the state as it
    is."""
    import jax.numpy as jnp
    from sph_tpu.physics.impulses import wave_impulse as jax_wave
    from sph_tpu_torch.app import configs as TCFG
    from sph_tpu_torch.core.convert import params_from_numpy, state_from_numpy

    d, params = shell_state_numpy()
    want = np.asarray(jax_wave(
        jax_state(d), amplitude=60.0 * float(params.dt) * n_substeps,
        wavelength=4.0, phase=0.7,
        direction=jnp.asarray([1.0, 0.0, 0.3])).vel)
    tp = params_from_numpy(to_numpy(params), device="cpu")
    ts = state_from_numpy(d, device="cpu")
    got = TCFG.frame_prologue("rotated_512k", tp, n_substeps)(ts)
    np.testing.assert_allclose(got.vel.numpy(), want, rtol=0, atol=WAVE_ATOL)
    assert np.abs(got.vel.numpy() - d["vel"]).max() > 0.5 * 0.06 * n_substeps
    for name in ("default_131k", "ghost_1m", "dam_break_8k"):
        assert TCFG.frame_prologue(name, tp, n_substeps)(ts) is ts


@pytest.fixture(scope="module")
def rotated_runs():
    """2 frames of (wave, 8 substeps) of the small rotated box: the port
    (cell engine, emitted rows) and JAX ``brute``, from the same spawn."""
    import jax
    import jax.numpy as jnp
    from sph_tpu.app import configs as JCFG
    from sph_tpu.engine import step as JSTEP
    from sph_tpu.physics.impulses import wave_impulse as jax_wave
    from sph_tpu_torch.app import configs as TCFG
    from sph_tpu_torch.engine import step as TSTEP
    from sph_tpu_torch.neighbors import sweeps

    js, jp, jcfg = JCFG.build(JCFG.BenchConfig(**ROTATED_SMALL),
                              neighbor_impl="brute")
    tcfg_b = TCFG.BenchConfig(**ROTATED_SMALL)
    ts, tp, tcfg = TCFG.build(tcfg_b, device="cpu")
    tcfg = dataclasses.replace(tcfg, emit_rows=True)
    start = {"jax": to_numpy(js), "port": {
        f.name: getattr(ts, f.name).numpy() for f in dataclasses.fields(ts)}}
    buf = JSTEP.SceneBuffers.create(jcfg)
    kick = jax.jit(lambda st: jax_wave(
        st, amplitude=60.0 * float(jp.dt) * 8, wavelength=4.0, phase=0.7,
        direction=jnp.asarray([1.0, 0.0, 0.3])))
    prologue = TCFG.frame_prologue(tcfg_b, tp, 8)
    tbuf = TSTEP.SceneBuffers.create(tcfg, device="cpu")
    calls = {"force_xsph": 0, "force_xsph_emit": 0}

    def counted(name):
        fn = getattr(sweeps, name)

        def call(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return call

    with pytest.MonkeyPatch.context() as mp:
        for name in calls:
            mp.setattr(sweeps, name, counted(name))
        for _ in range(2):
            js, buf = JSTEP.run_substeps(kick(js), jp, buf, jp.dt, 8, jcfg)
            ts, tbuf = TSTEP.run_substeps(prologue(ts), tp, tbuf, tp.dt, 8,
                                          tcfg)
    return start, to_numpy(js), {f.name: getattr(ts, f.name).numpy()
                                 for f in dataclasses.fields(ts)}, tp, calls


def test_rotated_wave_path_matches_jax_brute(rotated_runs):
    start, ref, got, _, _ = rotated_runs
    for k, want in start["jax"].items():
        np.testing.assert_array_equal(start["port"][k], want, err_msg=k)
    ia, ib = np.argsort(ref["orig_id"]), np.argsort(got["orig_id"])
    v = ref["valid"][ia] > 0
    assert v.sum() == 1960          # the spawn caps the column at 40%
    err = {f: float(np.abs(ref[f][ia][v] - got[f][ib][v]).max())
           for f in ("pos", "vel", "density")}
    assert err["pos"] < POS_TOL, err
    assert err["vel"] < VEL_TOL, err
    assert err["density"] < RHO_TOL, err


def test_rotated_wave_path_runs_emitted_rows_and_stays_in_the_box(
        rotated_runs):
    """The port's run took the emitted-row transport in all 16 substeps
    and kept every fluid row in the rotated box, under the CFL cap, above
    the density floor."""
    import torch
    from sph_tpu_torch.core.params import rotation_matrix
    _, ref, got, tp, calls = rotated_runs
    assert calls == {"force_xsph": 0, "force_xsph_emit": 16}
    v = got["valid"] > 0
    pos = torch.as_tensor(got["pos"][v])
    local = (pos - tp.box_center) @ rotation_matrix(tp.box_euler_deg)
    assert bool((local.abs() <= tp.box_half + 1e-4).all())
    assert np.linalg.norm(got["vel"][v], axis=-1).max() <= 0.4 * 0.28 / 1e-3
    assert got["density"][v].min() >= 500.0 - 1e-3
    # the waves moved the fluid: it is not at rest after 16 substeps
    assert np.abs(got["vel"][v]).max() > 0.1


# ---------------------------------------------------------------------------
# vortex, attractor, curl flow and stencil
# ---------------------------------------------------------------------------

# vortex: (shape_type, box_half, box_euler_deg, tangent kick, inward kick)
VORTICES = {
    "box": (0, (3.0, 3.0, 3.0), (0.0, 0.0, 0.0), 0.07, 0.02),
    "torus_tilted": (3, (7.0, 2.2, 0.0), (15.0, 0.0, -30.0), 0.0667, 0.0167),
    "sphere_inward_only": (1, (7.0, 7.0, 7.0), (0.0, 40.0, 0.0), 0.0, 0.5),
}
# attractor: (point, pull kick, radius)
ATTRACTORS = {
    "orb": ((10.0, 2.0, -10.0), 0.133, 6.0),
    "small_radius": ((7.7, -1.7, -10.0), 1.5, 0.8),
    "repel": ((12.0, -1.0, -8.0), -0.4, 20.0),
}
# curl flow: (kick, scale, time)
CURLS = {"silk": (0.05, 0.15, 0.3), "fine": (0.2, 1.7, -4.25),
         "min_scale": (0.1, 0.0, 12.0)}


def port_shell(d, params):
    from sph_tpu_torch.core.convert import params_from_numpy, state_from_numpy
    return (state_from_numpy(d, device="cpu"),
            params_from_numpy(to_numpy(params), device="cpu"))


def assert_impulse(got, d, want, still):
    """``got`` (the port's velocities) within WAVE_ATOL of ``want``;
    the ``still`` rows keep their velocity exactly."""
    got = got.numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=WAVE_ATOL)
    np.testing.assert_array_equal(got[still], d["vel"][still])
    assert int((got != d["vel"]).any(axis=1).sum()) > 50


@pytest.mark.parametrize("case", list(VORTICES))
def test_vortex_impulse_matches_jax(case):
    from sph_tpu.physics.impulses import vortex_impulse as jax_vortex
    from sph_tpu_torch.physics.impulses import vortex_impulse
    shape, half, euler, tangent, inward = VORTICES[case]
    d, params = shell_state_numpy()
    d["pos"] = d["pos"] - np.float32(10.0) * np.asarray([1.0, 0.0, -1.0],
                                                        np.float32)
    params = params.replace(shape_type=shape,
                            box_half=np.asarray(half, np.float32),
                            box_euler_deg=np.asarray(euler, np.float32))
    want = jax_vortex(jax_state(d), params, tangent, inward).vel
    ts, tp = port_shell(d, params)
    got = vortex_impulse(ts, tp, tangent, inward).vel
    assert_impulse(got, d, want, (d["ghost"] > 0) | (d["valid"] == 0))


@pytest.mark.parametrize("case", list(ATTRACTORS))
def test_attractor_impulse_matches_jax(case):
    from sph_tpu.physics.impulses import attractor_impulse as jax_attractor
    from sph_tpu_torch.physics.impulses import attractor_impulse
    point, pull, radius = ATTRACTORS[case]
    d, params = shell_state_numpy()
    want = jax_attractor(jax_state(d), np.asarray(point, np.float32), pull,
                         radius).vel
    ts, _ = port_shell(d, params)
    got = attractor_impulse(ts, point, pull, radius).vel
    assert_impulse(got, d, want, (d["ghost"] > 0) | (d["valid"] == 0))


def test_noise_is_the_jax_functions_op_by_op():
    """``_hash13``, ``_vnoise`` and ``curl_noise`` bit for bit against the
    JAX package's functions run op by op (``jax.disable_jit``): the jitted
    JAX hash differs from its own op-by-op one (tests/test_torch_viz.py)."""
    import jax
    import jax.numpy as jnp
    from sph_tpu.physics import impulses as JI
    from sph_tpu_torch.physics import impulses as TI
    rng = np.random.default_rng(11)
    pts = rng.uniform(-20, 20, (2048, 3)).astype(np.float32)
    tp = torch.as_tensor(pts)
    with jax.disable_jit():
        for name in ("_hash13", "_vnoise", "curl_noise"):
            want = np.asarray(getattr(JI, name)(jnp.asarray(pts)))
            np.testing.assert_array_equal(getattr(TI, name)(tp).numpy(),
                                          want, err_msg=name)


@pytest.mark.parametrize("case", list(CURLS))
def test_curl_flow_matches_jax(case):
    import jax
    from sph_tpu.physics.impulses import curl_flow as jax_curl
    from sph_tpu_torch.physics.impulses import curl_flow
    kick, scale, time = CURLS[case]
    d, params = shell_state_numpy()
    with jax.disable_jit():
        want = jax_curl(jax_state(d), kick, scale, time).vel
    ts, _ = port_shell(d, params)
    got = curl_flow(ts, kick, scale, time).vel
    assert_impulse(got, d, want, (d["ghost"] > 0) | (d["valid"] == 0))


@pytest.mark.parametrize("num", [37, 4096, 0])
def test_stencil_attract_matches_jax(num):
    """Each row springs toward targets[orig_id % num] (rows shuffled, so
    orig_id is not the row index); with no targets nothing moves."""
    import jax.numpy as jnp
    from sph_tpu.physics.impulses import stencil_attract as jax_stencil
    from sph_tpu_torch.physics.impulses import stencil_attract
    d, params = shell_state_numpy()
    perm = np.random.default_rng(2).permutation(len(d["pos"]))
    d = {k: v[perm] for k, v in d.items()}
    targets = np.random.default_rng(3).uniform(
        -3, 3, (4096, 3)).astype(np.float32)
    want = jax_stencil(jax_state(d), jnp.asarray(targets), num, 0.1,
                       0.033).vel
    ts, _ = port_shell(d, params)
    got = stencil_attract(ts, torch.as_tensor(targets), num, 0.1, 0.033).vel
    still = (d["ghost"] > 0) | (d["valid"] == 0)
    if num == 0:
        np.testing.assert_array_equal(got.numpy(), d["vel"])
    else:
        assert_impulse(got, d, want, still)


# ---------------------------------------------------------------------------
# the JAX reference density of a wave configuration
# ---------------------------------------------------------------------------

def jax_wave_reference(name: str, frames: int, per_frame: int,
                       capacity: int, seed: int = 0):
    """Yield (substeps done, fluid density max, mean, largest cell
    occupancy so far, rows past ``capacity`` so far) after each frame of
    ``sph_tpu`` ``binned`` at ``name``: the wave prologue of ``bench.py``
    (``:79-88``), then ``per_frame`` substeps."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from sph_tpu.app import configs as JCFG
    from sph_tpu.engine import step as JSTEP
    from sph_tpu.neighbors import binned as JB
    from sph_tpu.physics.impulses import wave_impulse

    cfg = JCFG.CONFIGS[name]
    state, params, sim = JCFG.build(cfg, seed=seed, neighbor_impl="binned")
    sim = dataclasses.replace(sim, cell_capacity=capacity)
    buf = JSTEP.SceneBuffers.create(sim)
    prologue = jax.jit(lambda st: wave_impulse(
        st, amplitude=60.0 * float(params.dt) * per_frame, wavelength=4.0,
        phase=0.7, direction=jnp.asarray([1.0, 0.0, 0.3])))
    keys = jax.jit(lambda st: JB.compute_keys(st, params, sim.grid_dims))
    cells = sim.num_cells
    worst, past = 0, 0
    for frame in range(frames):
        if cfg.wave_impulse:
            state = prologue(state)
        for _ in range(per_frame):
            occ = np.bincount(np.asarray(keys(state)),
                              minlength=cells + 1)[:cells]
            worst = max(worst, int(occ.max()))
            past += int(np.maximum(occ - capacity, 0).sum())
            state, buf = JSTEP.run_substeps(state, params, buf, params.dt,
                                            1, sim)
        fluid = (np.asarray(state.valid) > 0) & (np.asarray(state.ghost) == 0)
        rho = np.asarray(state.density)[fluid]
        yield ((frame + 1) * per_frame, float(rho.max()),
               float(rho.astype(np.float64).mean()), worst, past)


if __name__ == "__main__":
    name, frames, per_frame, cap = (sys.argv[1], int(sys.argv[2]),
                                    int(sys.argv[3]), int(sys.argv[4]))
    for done, rho_max, rho_mean, worst, past in jax_wave_reference(
            name, frames, per_frame, cap):
        print(f"{name} substep {done}: fluid density max {rho_max!r} mean "
              f"{rho_mean!r}; largest cell {worst} rows, {past} rows past "
              f"capacity {cap}", flush=True)
