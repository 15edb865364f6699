"""sph_tpu_torch.physics against sph_tpu.physics: smoothing kernels,
pointwise SPH math, the all-pairs oracle and the box container."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_tpu.core import params as JP
from sph_tpu.core import state as JS
from sph_tpu.physics import brute_force as JBF
from sph_tpu.physics import common as JC
from sph_tpu.physics import constraints as JCON
from sph_tpu.physics import kernels as JK
from sph_tpu_torch.core import params as TP
from sph_tpu_torch.core.convert import params_from_numpy, state_from_numpy
from sph_tpu_torch.physics import brute_force as TBF
from sph_tpu_torch.physics import common as TC
from sph_tpu_torch.physics import constraints as TCON
from sph_tpu_torch.physics import kernels as TK


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU ops on one thread while this module runs: the suite
    runs in several processes at once, where each process's pool of torch
    threads spins against the others'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL = 1e-6


def to_numpy(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def t(a):
    return torch.as_tensor(np.array(a))


def close(got, want, rtol=RTOL, atol=0.0, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(11)


@pytest.fixture(scope="module")
def jparams():
    return JP.FluidParams.default().derive_mass()


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_numpy(to_numpy(jparams), device="cpu")


def test_constants_pinned():
    for name in ("XSPH_COEFF", "VELOCITY_DAMPING", "FOAM_DECAY",
                 "DENSITY_FLOOR_FRAC", "CFL_FRACTION", "SURFACE_THRESHOLD"):
        assert getattr(TC, name) == getattr(JC, name), name
    assert TK._PI == JK._PI


def test_smoothing_kernels(rng):
    h = np.float32(0.28)
    r = np.concatenate([[0.0, h, h * 1.0001, 1e-9],
                        rng.uniform(0, 0.35, 500)]).astype(np.float32)
    r2 = (r * r).astype(np.float32)
    hj, ht = jnp.float32(h), torch.tensor(h)
    close(TK.poly6(t(r2), ht), JK.poly6(r2, hj))
    close(TK.spiky_grad_mag_over_r(t(r), ht),
          JK.spiky_grad_mag_over_r(r, hj))
    close(TK.visc_laplacian(t(r), ht), JK.visc_laplacian(r, hj))


def test_pair_force_terms(rng, jparams, tparams):
    n = 400
    rij = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    r = np.sqrt((rij * rij).sum(-1)).astype(np.float32)
    vi, vj = (rng.normal(0, 3, (n, 3)).astype(np.float32) for _ in range(2))
    pi, pj = (rng.uniform(0, 4e5, n).astype(np.float32) for _ in range(2))
    rho = rng.uniform(500, 3000, n).astype(np.float32)
    mask = rng.uniform(size=n) > 0.3
    want = JC.pair_force_terms(rij, r, vi, vj, pi, pj, rho, jparams.h,
                               jparams.mass, mask)
    got = TC.pair_force_terms(t(rij), t(r), t(vi), t(vj), t(pi), t(pj),
                              t(rho), tparams.h, tparams.mass, t(mask))
    for g, w in zip(got, want):
        close(g, w, rtol=1e-5, atol=1e-6)


def test_pointwise(rng, jparams, tparams):
    n = 300
    rho_raw = rng.uniform(0, 3000, n).astype(np.float32)
    ghost = (rng.uniform(size=n) > 0.7).astype(np.int32)
    contrib = rng.uniform(size=n) > 0.5
    old_rho = rng.uniform(500, 1500, n).astype(np.float32)
    old_p = rng.uniform(0, 1e5, n).astype(np.float32)
    for g, w in zip(
            TC.finish_density(t(rho_raw), t(ghost), t(contrib), t(old_rho),
                              t(old_p), tparams),
            JC.finish_density(rho_raw, ghost, contrib, old_rho, old_p,
                              jparams)):
        close(g, w)

    acc3 = [rng.normal(0, 5e4, (n, 3)).astype(np.float32) for _ in range(3)]
    acc3[2][:20] = 0.0        # grad_c below the surface threshold
    lap = rng.normal(0, 1e3, n).astype(np.float32)
    dens = rng.uniform(500, 3000, n).astype(np.float32)
    close(TC.assemble_acc(TC.ForceAccum(*map(t, acc3), t(lap)), t(dens),
                          tparams),
          JC.assemble_acc(JC.ForceAccum(*acc3, lap), dens, jparams),
          rtol=1e-5, atol=1e-3)

    pos = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    vel = rng.normal(0, 60, (n, 3)).astype(np.float32)
    acc = rng.normal(0, 1e3, (n, 3)).astype(np.float32)
    dt = np.float32(1e-3)
    for g, w in zip(TC.integrate(t(pos), t(vel), t(acc), dt),
                    JC.integrate(pos, vel, acc, dt)):
        close(g, w)
    xs = rng.normal(0, 10, (n, 3)).astype(np.float32)
    xn = np.where(rng.uniform(size=n) > 0.2,
                  rng.uniform(0, 5, n), 0.0).astype(np.float32)
    close(TC.apply_xsph(t(vel), t(xs), t(xn)), JC.apply_xsph(vel, xs, xn))
    close(TC.speed_cap(t(vel), tparams.h, dt),
          JC.speed_cap(vel, jparams.h, dt))
    foam = rng.uniform(0, 1, n).astype(np.float32)
    close(TC.foam_update(t(foam), t(vel), t(dens), tparams),
          JC.foam_update(foam, vel, dens, jparams))
    m = rng.uniform(size=n) > 0.5
    close(TC.select_updated(t(m), t(vel), t(acc)),
          JC.select_updated(m, vel, acc))
    close(TC.select_updated(t(m), t(dens), t(rho_raw)),
          JC.select_updated(m, dens, rho_raw))


# ---------------------------------------------------------------------------
# the all-pairs oracle
# ---------------------------------------------------------------------------

def _ghost_shell():
    half = (3.0, 3.0, 3.0)
    spawn = JS.concat_spawns(
        JS.spawn_standard(256, h=0.28, box_half=half, seed=1),
        JS.spawn_ghost_box_shell(h=0.28, box_half=half))
    state = JS.state_from_spawn(spawn)
    active = np.asarray([1, 0, 1, 1, 0, 1], np.int32)  # two faces off
    params = JP.FluidParams.default(
        box_half=np.asarray(half, np.float32),
        ghost_face_active=active).derive_mass()
    return state, params


@pytest.fixture(scope="module")
def oracle_cases(dam_break_small):
    js, jp, _ = dam_break_small
    # a few substeps in, so velocities and densities are non-trivial
    from sph_tpu.engine.step import SceneBuffers, run_substeps
    cfg = JP.SimConfig(n=js.n, grid_dims=(8, 8, 8), neighbor_impl="brute")
    js, _ = run_substeps(js, jp, SceneBuffers.create(cfg), jp.dt, 3, cfg)
    return {"dam_break": (js, jp), "ghost_shell": _ghost_shell()}


@pytest.mark.parametrize("case", ["dam_break", "ghost_shell"])
def test_brute_passes_match(oracle_cases, case):
    js, jp = oracle_cases[case]
    ts = state_from_numpy(to_numpy(js), device="cpu")
    tp = params_from_numpy(to_numpy(jp), device="cpu")
    ids_j = jnp.arange(js.n, dtype=jnp.int32)
    ids_t = torch.arange(ts.n, dtype=torch.int32)
    cj = js.contrib_mask(jp.ghost_face_active)
    ct = ts.contrib_mask(tp.ghost_face_active)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))

    rho_j = JBF.density_pass(js.pos, js.pos, cj, jp)
    rho_t = TBF.density_pass(ts.pos, ts.pos, ct, tp)
    close(rho_t, rho_j, rtol=1e-5, atol=1e-2)
    dj, pj = JC.finish_density(rho_j, js.ghost, cj, js.density, js.pressure,
                               jp)
    dt_, pt = t(np.asarray(dj)), t(np.asarray(pj))

    fj = JBF.force_pass(js.pos, js.vel, pj, ids_j, js.pos, js.vel, dj, pj,
                        cj, ids_j, jp)
    ft = TBF.force_pass(ts.pos, ts.vel, pt, ids_t, ts.pos, ts.vel, dt_, pt,
                        ct, ids_t, tp)
    for g, w in zip(ft, fj):
        scale = float(np.abs(np.asarray(w)).max())
        close(g, w, rtol=1e-4, atol=1e-5 * scale)

    new_pos = np.asarray(js.pos) + 1e-3 * np.asarray(js.vel)
    xj = JBF.xsph_pass(new_pos, js.vel, ids_j, js.pos, js.vel, dj, cj,
                       ids_j, jp)
    xt = TBF.xsph_pass(t(new_pos), ts.vel, ids_t, ts.pos, ts.vel, dt_, ct,
                       ids_t, tp)
    for g, w in zip(xt, xj):
        scale = float(np.abs(np.asarray(w)).max())
        close(g, w, rtol=1e-4, atol=1e-5 * scale + 1e-7)


@pytest.mark.parametrize("case", ["dam_break", "ghost_shell"])
def test_brute_substep_matches(oracle_cases, case):
    js, jp = oracle_cases[case]
    ts = state_from_numpy(to_numpy(js), device="cpu")
    tp = params_from_numpy(to_numpy(jp), device="cpu")
    want = to_numpy(JBF.substep(js, jp, jp.dt))
    got = TBF.substep(ts, tp, tp.dt)
    v = np.asarray(js.valid) > 0
    for f, tol in (("pos", 1e-5), ("vel", 1e-3), ("density", 1e-2),
                   ("foam", 1e-5)):
        err = np.abs(getattr(got, f).numpy()[v] - want[f][v]).max()
        assert err < tol, (f, err)
    for f in ("ghost", "valid", "orig_id", "face"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), want[f])
    gm = np.asarray(js.ghost) > 0
    if gm.any():
        on = gm & np.asarray(js.contrib_mask(jp.ghost_face_active))
        assert np.abs(got.vel.numpy()[on]).max() == 0.0
        close(got.density.numpy()[on], 1000.0)


# ---------------------------------------------------------------------------
# box container
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("euler", [(0.0, 0.0, 0.0), (20.0, 0.0, 30.0)])
def test_apply_container_box(rng, euler):
    n = 2000
    half = np.asarray([3.0, 2.0, 2.5], np.float32)
    jp = JP.FluidParams.default(
        box_half=half, box_center=np.asarray([0.5, -0.25, 0.0], np.float32),
        box_euler_deg=np.asarray(euler, np.float32),
        wall_restitution=0.3, wall_friction=0.1)
    spawn = JS.SpawnResult(
        pos=rng.uniform(-4.5, 4.5, (n, 3)).astype(np.float32),
        vel=rng.normal(0, 20, (n, 3)).astype(np.float32),
        ghost=(rng.uniform(size=n) > 0.9).astype(np.int32),
        face=np.full((n,), -1, np.int32),
        color_group=np.zeros((n,), np.int32), count=n)
    js = JS.state_from_spawn(spawn, pad_to=n + 48)
    want = JCON.apply_container(js, jp)
    got = TCON.apply_container(state_from_numpy(to_numpy(js), device="cpu"),
                               params_from_numpy(to_numpy(jp), device="cpu"))
    close(got.pos, want.pos, rtol=1e-5, atol=2e-6)
    close(got.vel, want.vel, rtol=1e-5, atol=2e-5)
    # particles the container moved are inside it (container frame)
    rot = TP.rotation_matrix(torch.as_tensor(np.asarray(euler, np.float32)))
    local = (got.pos - torch.tensor([0.5, -0.25, 0.0])) @ rot
    live = torch.as_tensor(np.asarray(js.valid) > 0) & (got.ghost == 0)
    assert bool((local[live].abs() <= torch.as_tensor(half) + 1e-4).all())
