"""The cell engine's sweeps (sph_tpu_torch.neighbors.sweeps).

CPU: the plain versions against the JAX package's all-pairs oracle
(``brute_force.density_pass`` + ``finish_density``; ``force_pass`` +
``assemble_acc`` + ``integrate`` + ``xsph_pass`` + ``apply_xsph`` +
``speed_cap``) on the 2k dam break, on a crowded block whose cells hold
more than 8 particles, which the capacity-free port must handle exactly,
and on a ghost-shell box with all faces on and with the top face off,
where the sweeps take the ghost structure as sources.

CUDA (marker ``cuda``, skipped without a card): each kernel against its
plain version.  JAX is imported inside the fixtures that need it, so the
CUDA tests also run where JAX is not installed:

    python -m pytest tests/test_torch_sweeps.py -q -m cuda --noconftest
"""
import dataclasses

import numpy as np
import pytest
import torch

from sph_tpu_torch.core import params as TP
from sph_tpu_torch.core import state as TS
from sph_tpu_torch.core.params import SimConfig
from sph_tpu_torch.neighbors import cells, sweeps

# tolerances of the plain versions against the oracle (different pair
# summation order), and of the kernels against the plain versions
RHO_RTOL, RHO_ATOL = 1e-5, 1e-2       # tests/test_solver_equivalence.py:49
POS_ATOL = 1e-5
VEL_ATOL = 1e-3
ACC_RTOL, ACC_ATOL = 1e-4, 1e-1       # |acc| is about |g| = 980


ALL_FACES = (1, 1, 1, 1, 1, 1)


def dam_break_case():
    """The 2k dam break of tests/conftest.py, spawned by the port."""
    half = (7.0, 7.0, 7.0)
    return TS.spawn_standard(2048, seed=7), half, 0.28, ALL_FACES


def crowded_case():
    """48 adjacent cells with 9-12 particles each (cell capacity 8 in the
    JAX cell engines), after test_pallas_engine.py:93-109."""
    half, h = (3.0, 3.0, 3.0), 0.4
    gmin = -(np.asarray(half, np.float32) + np.float32(h))
    rng = np.random.default_rng(3)
    pos = []
    for i in range(6, 10):
        for j in range(2, 5):
            for k in range(6, 10):
                m = 9 + (i + 2 * j + k) % 4
                base = gmin + (np.array([i, j, k], np.float32) + 0.5) * h
                pos.append(base + (rng.random((m, 3)).astype(np.float32)
                                   - 0.5) * 0.9 * h)
    pos = np.concatenate(pos).astype(np.float32)
    n = pos.shape[0]
    return TS.SpawnResult(
        pos=pos, vel=np.zeros((n, 3), np.float32),
        ghost=np.zeros((n,), np.int32), face=np.full((n,), -1, np.int32),
        color_group=np.zeros((n,), np.int32), count=n), half, h, ALL_FACES


def ghost_shell_case(active=ALL_FACES):
    """512 fluid particles in a box of half 3 inside the ghost shell, as
    tests/test_pallas_engine.py:46-69, moved into the -X, -Y, -Z corner
    so that the walls' ghosts are within h of the fluid from the start."""
    half = (3.0, 3.0, 3.0)
    fluid = TS.spawn_standard(512, h=0.28, box_half=half, seed=1)
    fluid.pos += np.asarray([-0.35, -0.2, -0.35], np.float32)
    spawn = TS.concat_spawns(
        fluid, TS.spawn_ghost_box_shell(h=0.28, box_half=half))
    return spawn, half, 0.28, active


CASES = {"dam_break": dam_break_case, "crowded": crowded_case,
         "ghost_shell": ghost_shell_case,
         # +Y (face 3) open: its ghosts are not sources
         "ghost_shell_open_top": lambda: ghost_shell_case((1, 1, 1, 0, 1, 1))}


def port_inputs(case, device="cpu", warm=2):
    """(state, params, dims) after ``warm`` plain cell substeps on the
    CPU, moved to ``device``."""
    from sph_tpu_torch.engine.step import run_substeps
    spawn, half, h, active = CASES[case]()
    state = TS.state_from_spawn(spawn, device="cpu")
    params = TP.FluidParams.default(
        device="cpu", h=h, box_half=np.asarray(half, np.float32),
        ghost_face_active=active).derive_mass()
    dims = TP.compute_grid_dims(TP.SHAPE_BOX, half, (0, 0, 0), h)
    state = run_substeps(state, params, params.dt, warm,
                         SimConfig(n=state.n, grid_dims=dims))
    move = {f.name: getattr(state, f.name).to(device)
            for f in dataclasses.fields(state)}
    pmove = {f.name: (v.to(device) if isinstance(v, torch.Tensor) else v)
             for f in dataclasses.fields(params)
             for v in [getattr(params, f.name)]}
    return TS.ParticleState(**move), TP.FluidParams(**pmove), dims


def sweep_inputs(state, params, dims):
    """(key, pos, vel, cell_start, cell_end), the sorted state, the sweep
    params and the ghost structure (None without ghosts)."""
    rows = cells.build(state, params, dims)
    pv, ghosts = sweeps.prepare(state, params, params.dt,
                                SimConfig(n=state.n, grid_dims=dims))
    s = rows.state
    return ((rows.key, s.pos, s.vel, rows.cell_start, rows.cell_end), s, pv,
            ghosts)


# ---------------------------------------------------------------------------
# plain versions against the JAX oracle (CPU)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def oracle():
    """Per case: the port's state and the JAX all-pairs outputs for it,
    indexed by orig_id."""
    import jax.numpy as jnp
    from sph_tpu.core.params import FluidParams as JFP
    from sph_tpu.core.state import ParticleState as JPS
    from sph_tpu.physics import brute_force as JBF
    from sph_tpu.physics import common as JC

    out = {}
    for case in CASES:
        state, params, dims = port_inputs(case)
        js = JPS(**{f.name: jnp.asarray(getattr(state, f.name).numpy())
                    for f in dataclasses.fields(state)})
        jp = JFP.default(
            h=float(params.h), box_half=params.box_half.numpy(),
            ghost_face_active=params.ghost_face_active.numpy()).derive_mass()
        ids = jnp.arange(js.n, dtype=jnp.int32)
        cj = js.contrib_mask(jp.ghost_face_active)
        rho_raw = JBF.density_pass(js.pos, js.pos, cj, jp)
        rho, pres = JC.finish_density(rho_raw, js.ghost, cj, js.density,
                                      js.pressure, jp)
        accum = JBF.force_pass(js.pos, js.vel, pres, ids, js.pos, js.vel,
                               rho, pres, cj, ids, jp)
        acc = JC.assemble_acc(accum, rho, jp)
        npos, nvel = JC.integrate(js.pos, js.vel, acc, jp.dt)
        xs, xn = JBF.xsph_pass(npos, nvel, ids, js.pos, js.vel, rho, cj,
                               ids, jp)
        nvel = JC.speed_cap(JC.apply_xsph(nvel, xs, xn), jp.h, jp.dt)
        # rows of the JAX outputs, re-indexed by orig_id
        by_oid = np.argsort(state.orig_id.numpy())
        want = {k: np.asarray(v)[by_oid] for k, v in dict(
            rho=rho, pres=pres, npos=npos, nvel=nvel, acc=acc).items()}
        out[case] = (state, params, dims, want)
    return out


def _fluid_rows(s):
    m = s.fluid_mask().numpy()
    return m, s.orig_id.numpy()[m]


@pytest.mark.parametrize("case", list(CASES))
def test_density_plain_matches_oracle(oracle, case):
    state, params, dims, want = oracle[case]
    (key, pos, _, cs, ce), s, pv, ghosts = sweep_inputs(state, params, dims)
    assert (ghosts is not None) == case.startswith("ghost")
    rho, pres = sweeps.density(key, pos, cs, ce, pv, ghosts)
    m, oid = _fluid_rows(s)
    np.testing.assert_allclose(rho.numpy()[m], want["rho"][oid],
                               rtol=RHO_RTOL, atol=RHO_ATOL)
    np.testing.assert_allclose(pres.numpy()[m], want["pres"][oid],
                               rtol=1e-4, atol=RHO_ATOL * pv.gas_k)
    assert np.all(rho.numpy()[~m] == 0.0)


@pytest.mark.parametrize("case", list(CASES))
def test_force_xsph_plain_matches_oracle(oracle, case):
    state, params, dims, want = oracle[case]
    (key, pos, vel, cs, ce), s, pv, ghosts = sweep_inputs(state, params,
                                                          dims)
    # the oracle's densities, in sorted order, isolate this sweep
    m, oid = _fluid_rows(s)
    rho = torch.zeros(s.n)
    rho[torch.as_tensor(m)] = torch.as_tensor(want["rho"][oid])
    npos, nvel, acc = sweeps.force_xsph(key, pos, vel, rho, cs, ce, pv,
                                        ghosts)
    np.testing.assert_allclose(npos.numpy()[m], want["npos"][oid], rtol=0,
                               atol=POS_ATOL)
    np.testing.assert_allclose(nvel.numpy()[m], want["nvel"][oid], rtol=0,
                               atol=VEL_ATOL)
    np.testing.assert_allclose(acc.numpy()[m], want["acc"][oid],
                               rtol=ACC_RTOL, atol=ACC_ATOL)
    # non-fluid rows pass through
    np.testing.assert_array_equal(npos.numpy()[~m], pos.numpy()[~m])
    assert np.all(acc.numpy()[~m] == 0.0)


def test_crowded_case_exceeds_capacity():
    state, params, dims = port_inputs("crowded", warm=0)
    rows = cells.build(state, params, dims)
    counts = (rows.cell_end - rows.cell_start).numpy()
    assert counts.max() > 8 and (counts > 8).sum() >= 40


def test_wrappers_on_cpu_take_plain_path_without_counting():
    state, params, dims = port_inputs("dam_break", warm=0)
    (key, pos, vel, cs, ce), _, pv, _ = sweep_inputs(state, params, dims)
    sweeps.reset_launches()
    rho, _ = sweeps.density(key, pos, cs, ce, pv)
    ref = sweeps.density_plain(key, pos, cs, ce, pv)[0]
    assert torch.equal(rho, ref)
    sweeps.force_xsph(key, pos, vel, rho, cs, ce, pv)
    assert sweeps.LAUNCHES == {"density": 0, "force_xsph": 0}


def test_wrappers_reject_other_devices():
    state, params, dims = port_inputs("dam_break", warm=0)
    (key, pos, vel, cs, ce), _, pv, _ = sweep_inputs(state, params, dims)
    meta = [t.to("meta") for t in (key, pos, vel, cs, ce)]
    with pytest.raises(ValueError, match="CUDA or CPU"):
        sweeps.density(meta[0], meta[1], meta[3], meta[4], pv)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        sweeps.force_xsph(meta[0], meta[1], meta[2], meta[1][:, 0],
                          meta[3], meta[4], pv)


def test_ghost_sources_reach_the_sweeps():
    """The ghost cases' wall rows see the shell: without the ghost
    structure the same sweeps give them less density."""
    state, params, dims = port_inputs("ghost_shell", warm=0)
    (key, pos, _, cs, ce), s, pv, ghosts = sweep_inputs(state, params, dims)
    assert ghosts.count == 4374
    with_g = sweeps.density(key, pos, cs, ce, pv, ghosts)[0]
    without = sweeps.density(key, pos, cs, ce, pv)[0]
    m = s.fluid_mask()
    assert bool((with_g[m] >= without[m]).all())
    assert int((with_g[m] > without[m] + 1.0).sum()) > 100


# ---------------------------------------------------------------------------
# kernels against the plain versions (CUDA only)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sweep kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_kernels_match_plain_on_cuda(cuda, case):
    state, params, dims = port_inputs(case, device=cuda)
    (key, pos, vel, cs, ce), _, pv, g = sweep_inputs(state, params, dims)
    sweeps.reset_launches()
    rho_k, pres_k = sweeps.density(key, pos, cs, ce, pv, g)
    rho_p, pres_p = sweeps.density_plain(key, pos, cs, ce, pv, g)
    torch.testing.assert_close(rho_k, rho_p, rtol=RHO_RTOL, atol=RHO_ATOL)
    torch.testing.assert_close(pres_k, pres_p, rtol=1e-4,
                               atol=RHO_ATOL * pv.gas_k)
    got = sweeps.force_xsph(key, pos, vel, rho_p, cs, ce, pv, g)
    want = sweeps.force_xsph_plain(key, pos, vel, rho_p, cs, ce, pv, g)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=POS_ATOL)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=VEL_ATOL)
    torch.testing.assert_close(got[2], want[2], rtol=ACC_RTOL, atol=ACC_ATOL)
    assert sweeps.LAUNCHES == {"density": 1, "force_xsph": 1}


@pytest.mark.cuda
def test_kernel_wrappers_check_inputs_on_cuda(cuda):
    state, params, dims = port_inputs("dam_break", device=cuda, warm=0)
    (key, pos, vel, cs, ce), _, pv, _ = sweep_inputs(state, params, dims)
    with pytest.raises(ValueError, match="dtype"):
        sweeps.density(key.long(), pos, cs, ce, pv)
    with pytest.raises(ValueError, match="contiguous"):
        sweeps.density(key, pos.t().contiguous().t(), cs, ce, pv)
    with pytest.raises(ValueError, match="shape"):
        sweeps.density(key, pos, cs[:-1], ce, pv)
    with pytest.raises(ValueError, match="is on"):
        sweeps.force_xsph(key, pos, vel, torch.zeros(key.shape[0]), cs, ce,
                          pv)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_cell_engine_on_cuda_matches_cpu(cuda, case):
    """20 substeps through the kernels against 20 through the plain
    versions, realigned by orig_id."""
    from sph_tpu_torch.engine.step import run_substeps
    outs = {}
    for dev in ("cpu", cuda):
        state, params, dims = port_inputs(case, device=dev, warm=0)
        sweeps.reset_launches()
        st = run_substeps(state, params, params.dt, 20,
                          SimConfig(n=state.n, grid_dims=dims))
        order = torch.argsort(st.orig_id)
        outs[str(dev)] = {f: getattr(st, f)[order].cpu()
                          for f in ("pos", "vel", "density", "valid")}
    assert sweeps.LAUNCHES == {"density": 20, "force_xsph": 20}
    ref, got = outs["cpu"], outs["cuda"]
    v = ref["valid"] > 0
    for f, tol in (("pos", 1e-4), ("vel", 1e-3), ("density", 1.0)):
        err = float((got[f][v] - ref[f][v]).abs().max())
        assert err < tol, (f, err)
