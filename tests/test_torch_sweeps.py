"""The cell engine's sweeps (sph_tpu_torch.neighbors.sweeps).

CPU: the plain versions against the JAX package's all-pairs oracle
(``brute_force.density_pass`` + ``finish_density``; ``force_pass`` +
``assemble_acc`` + ``integrate`` + ``xsph_pass`` + ``apply_xsph`` +
``speed_cap``) on the 2k dam break, on a crowded block whose cells hold
more than 8 particles, which the capacity-free port must handle exactly,
and on a ghost-shell box with all faces on and with the top face off,
where the sweeps take the ghost structure as sources; the emitted-row
transport (``SimConfig.emit_rows``) bit-identical to the default on each;
and the force kernel's source records (``pack_sources``,
``density_sources``) against the same oracle; and the force kernel's tile
rule (``tile_warp_count``: aligned warps of 32 fluid rows in one x-run of
cells or two, each run's within two cells or a row's three cells crowded)
on the blocking fixtures, built to break a kernel's blocking, and on
crowded cells in one x-run and across the end of one.

CUDA (marker ``cuda``, skipped without a card): each kernel against its
plain version; the force kernels' tile-path counter against
``tile_warp_count``, and a crowded cell's rows bit-equal whichever path
their warps take; the container pass (``csrc/container.cu``) in its three
modes, reassembly, container and both, bit-identical to the plain torch
ops on the card for a box at zero angles, with and without ghosts, from
separate output columns and from the emitted rows.  JAX is imported inside the fixtures that need it, so the
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
from sph_tpu_torch.physics import constraints
from sph_tpu_torch.utils import trace


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU ops on one thread while this module runs: the suite
    runs in several processes at once, where each process's pool of torch
    threads spins against the others'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    from sph_tpu_torch.engine.step import SceneBuffers, run_substeps
    spawn, half, h, active = CASES[case]()
    state = TS.state_from_spawn(spawn, device="cpu")
    params = TP.FluidParams.default(
        device="cpu", h=h, box_half=np.asarray(half, np.float32),
        ghost_face_active=active).derive_mass()
    dims = TP.compute_grid_dims(TP.SHAPE_BOX, half, (0, 0, 0), h)
    cfg = SimConfig(n=state.n, grid_dims=dims)
    state, _ = run_substeps(state, params,
                            SceneBuffers.create(cfg, device="cpu"),
                            params.dt, warm, cfg)
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


def sweep_launches():
    """The launch counters of the three sweep kernels."""
    return {k: trace.counter(f"launches.{k}")
            for k in ("density", "force_xsph", "force_xsph_emit")}


def test_wrappers_on_cpu_take_plain_path_without_counting():
    state, params, dims = port_inputs("dam_break", warm=0)
    (key, pos, vel, cs, ce), _, pv, _ = sweep_inputs(state, params, dims)
    trace.reset()
    rho, _ = sweeps.density(key, pos, cs, ce, pv)
    ref = sweeps.density_plain(key, pos, cs, ce, pv)[0]
    assert torch.equal(rho, ref)
    sweeps.force_xsph(key, pos, vel, rho, cs, ce, pv)
    sweeps.force_xsph_emit(key, pos, vel, rho, cs, ce, pv)
    assert sweep_launches() == {"density": 0, "force_xsph": 0,
                                "force_xsph_emit": 0}


def test_wrappers_reject_other_devices():
    state, params, dims = port_inputs("dam_break", warm=0)
    (key, pos, vel, cs, ce), _, pv, _ = sweep_inputs(state, params, dims)
    meta = [t.to("meta") for t in (key, pos, vel, cs, ce)]
    with pytest.raises(ValueError, match="CUDA or CPU"):
        sweeps.density(meta[0], meta[1], meta[3], meta[4], pv)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        sweeps.force_xsph(meta[0], meta[1], meta[2], meta[1][:, 0],
                          meta[3], meta[4], pv)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        sweeps.force_xsph_emit(meta[0], meta[1], meta[2], meta[1][:, 0],
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


STATE_FIELDS = ("pos", "vel", "acc", "density", "pressure", "foam",
                "orig_id", "ghost", "valid")


def run_both_transports(state, params, dims, n_sub):
    """``n_sub`` cell substeps with and without ``emit_rows``."""
    from sph_tpu_torch.engine.step import SceneBuffers, run_substeps
    cfg = SimConfig(n=state.n, grid_dims=dims)
    buffers = SceneBuffers.create(cfg, device=state.pos.device)
    return [run_substeps(state, params, buffers, params.dt, n_sub,
                         dataclasses.replace(cfg, emit_rows=emit))[0]
            for emit in (False, True)]


@pytest.mark.parametrize("case", ["dam_break", "ghost_shell_open_top"])
def test_emit_rows_bit_identical_to_gather(case):
    """The emitted-row transport is a pure transport: 2 substeps with it
    equal 2 without, bit for bit, as in the JAX package
    (tests/test_pallas_engine.py:339), without ghosts and with them."""
    state, params, dims = port_inputs(case, warm=0)
    gather, emit = run_both_transports(state, params, dims, 2)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(emit, f), getattr(gather, f)), f


def test_emit_rows_layout():
    """per's columns: npos, nvel, acc, rho (the input), then six zeros."""
    state, params, dims = port_inputs("ghost_shell_open_top", warm=0)
    (key, pos, vel, cs, ce), _, pv, g = sweep_inputs(state, params, dims)
    rho, _ = sweeps.density(key, pos, cs, ce, pv, g)
    per = sweeps.force_xsph_emit(key, pos, vel, rho, cs, ce, pv, g)
    npos, nvel, acc = sweeps.force_xsph(key, pos, vel, rho, cs, ce, pv, g)
    assert per.shape == (key.shape[0], sweeps.EMIT_COLS) == (state.n, 16)
    for cols, want in (((0, 3), npos), ((3, 6), nvel), ((6, 9), acc),
                       ((9, 10), rho[:, None]),
                       ((10, 16), torch.zeros(state.n, 6))):
        assert torch.equal(per[:, cols[0]:cols[1]], want), cols


@pytest.mark.parametrize("case", list(CASES))
def test_density_sources_match_density_and_oracle(oracle, case):
    """``density_sources`` is ``density`` plus the force sweep's source
    records: the same rho and pres bit for bit, the records' rho column
    against the JAX oracle's density (the density tolerance), m / rho from
    it, and pos and vel carried exactly."""
    state, params, dims, want = oracle[case]
    (key, pos, vel, cs, ce), s, pv, ghosts = sweep_inputs(state, params,
                                                          dims)
    rho, pres, src = sweeps.density_sources(key, pos, vel, cs, ce, pv, ghosts)
    ref = sweeps.density(key, pos, cs, ce, pv, ghosts)
    assert torch.equal(rho, ref[0]) and torch.equal(pres, ref[1])
    n, g = state.n, 0 if ghosts is None else ghosts.count
    assert src.shape == (2, n + g, 4) and src.is_contiguous()
    assert torch.equal(src[0, :n, :3], pos) and torch.equal(src[1, :n, :3],
                                                            vel)
    m, oid = _fluid_rows(s)
    np.testing.assert_allclose(src[0, :n, 3].numpy()[m], want["rho"][oid],
                               rtol=RHO_RTOL, atol=RHO_ATOL)
    np.testing.assert_allclose(
        src[1, :n, 3].numpy()[m], np.float32(pv.mass) / want["rho"][oid],
        rtol=2 * RHO_RTOL, atol=0)
    if g:
        assert torch.equal(src[:, n:], ghosts.records)


@pytest.mark.parametrize("case", ["dam_break", "ghost_shell_open_top"])
def test_source_records_carry_the_force_sweeps_inputs(case):
    """Everything the force sweep reads of a source is in its two records:
    the sweep on pos, vel and rho read back from the records equals the
    sweep on the originals bit for bit, and m / rho is a true float32
    division (what the kernel computes), dead rows included."""
    state, params, dims = port_inputs(case)
    (key, pos, vel, cs, ce), _, pv, g = sweep_inputs(state, params, dims)
    rho, _ = sweeps.density(key, pos, cs, ce, pv, g)
    src = sweeps.pack_sources(pos, vel, rho, pv, g)
    n = state.n
    back = (src[0, :n, :3].contiguous(), src[1, :n, :3].contiguous(),
            src[0, :n, 3].contiguous())
    for a, b in zip(sweeps.force_xsph(key, *back, cs, ce, pv, g, src),
                    sweeps.force_xsph(key, pos, vel, rho, cs, ce, pv, g)):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(
        src[1, :n, 3].numpy(),
        np.float32(pv.mass) / np.maximum(rho.numpy(), np.float32(1e-12)))
    assert bool((rho == 0).any()) == bool((~state.fluid_mask()).any())


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
    trace.reset()
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
    assert sweep_launches() == {"density": 1, "force_xsph": 1,
                                "force_xsph_emit": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_density_kernel_packs_source_records_on_cuda(cuda, case):
    """The records that ``density_kernel`` writes are bit-equal to the
    plain packing of its own rho; rho and pres do not depend on them; and
    the force kernels on those records equal the force kernels on records
    packed by the wrapper."""
    state, params, dims = port_inputs(case, device=cuda)
    (key, pos, vel, cs, ce), _, pv, g = sweep_inputs(state, params, dims)
    trace.reset()
    rho, pres, src = sweeps.density_sources(key, pos, vel, cs, ce, pv, g)
    ref = sweeps.density(key, pos, cs, ce, pv, g)
    torch.cuda.synchronize()
    assert torch.equal(rho, ref[0]) and torch.equal(pres, ref[1])
    assert torch.equal(src, sweeps.pack_sources(pos, vel, rho, pv, g))
    args = (key, pos, vel, rho, cs, ce, pv, g)
    for a, b in zip(sweeps.force_xsph(*args, src), sweeps.force_xsph(*args)):
        assert torch.equal(a, b)
    assert torch.equal(sweeps.force_xsph_emit(*args, src),
                       sweeps.force_xsph_emit(*args))
    assert sweep_launches() == {"density": 2, "force_xsph": 2,
                                "force_xsph_emit": 2}
    with pytest.raises(ValueError, match="shape"):
        sweeps.force_xsph(*args, src[:, :-1].contiguous())


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
    from sph_tpu_torch.engine.step import SceneBuffers, run_substeps
    outs = {}
    for dev in ("cpu", cuda):
        state, params, dims = port_inputs(case, device=dev, warm=0)
        trace.reset()
        cfg = SimConfig(n=state.n, grid_dims=dims)
        st, _ = run_substeps(state, params,
                             SceneBuffers.create(cfg, device=dev), params.dt,
                             20, cfg)
        order = torch.argsort(st.orig_id)
        outs[str(dev)] = {f: getattr(st, f)[order].cpu()
                          for f in ("pos", "vel", "density", "valid")}
    assert sweep_launches() == {"density": 20, "force_xsph": 20,
                                "force_xsph_emit": 0}
    ref, got = outs["cpu"], outs["cuda"]
    v = ref["valid"] > 0
    for f, tol in (("pos", 1e-4), ("vel", 1e-3), ("density", 1.0)):
        err = float((got[f][v] - ref[f][v]).abs().max())
        assert err < tol, (f, err)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_emit_kernel_matches_plain_on_cuda(cuda, case):
    state, params, dims = port_inputs(case, device=cuda)
    (key, pos, vel, cs, ce), _, pv, g = sweep_inputs(state, params, dims)
    rho, _ = sweeps.density_plain(key, pos, cs, ce, pv, g)
    trace.reset()
    got = sweeps.force_xsph_emit(key, pos, vel, rho, cs, ce, pv, g)
    want = sweeps.force_xsph_emit_plain(key, pos, vel, rho, cs, ce, pv, g)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[:, 0:3], want[:, 0:3], rtol=0,
                               atol=POS_ATOL)
    torch.testing.assert_close(got[:, 3:6], want[:, 3:6], rtol=0,
                               atol=VEL_ATOL)
    torch.testing.assert_close(got[:, 6:9], want[:, 6:9], rtol=ACC_RTOL,
                               atol=ACC_ATOL)
    assert torch.equal(got[:, 9:], want[:, 9:])
    # the same sweep as force_xsph_kernel, bit for bit
    npos, nvel, acc = sweeps.force_xsph(key, pos, vel, rho, cs, ce, pv, g)
    assert torch.equal(got[:, :9], torch.cat([npos, nvel, acc], 1))
    assert sweep_launches() == {"density": 0, "force_xsph": 1,
                                "force_xsph_emit": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_emit_rows_bit_identical_to_gather_on_cuda(cuda, case):
    state, params, dims = port_inputs(case, device=cuda)
    trace.reset()
    gather, emit = run_both_transports(state, params, dims, 5)
    assert sweep_launches() == {"density": 10, "force_xsph": 5,
                                "force_xsph_emit": 5}
    for f in STATE_FIELDS:
        assert torch.equal(getattr(emit, f), getattr(gather, f)), f


def reassembly_inputs(device, ghosts, emit, n=6000, seed=11):
    """A state and the sweeps' outputs for it, made up row by row on
    ``device``: positions over 1.3x a box of half 3 (every face and corner
    hit), densities about rho0 and speeds up to the foam's reference (foam
    on most fluid rows), 5% padding; with ``ghosts`` a tenth of the rows are
    ghosts on the six faces, +Y and -Z inactive.  With ``emit`` the sweeps'
    columns are views of one [n, 16] buffer, as the emitted-row transport
    hands them over.  Returns (state, (rho, pres, npos, nvel, acc), params)."""
    rng = np.random.default_rng(seed)

    def t(a, dtype=np.float32):
        return torch.as_tensor(np.asarray(a, dtype), device=device)

    def vec(scale):
        return rng.standard_normal((n, 3)) * scale

    ghost = (rng.uniform(size=n) < 0.1) if ghosts else np.zeros(n, bool)
    state = TS.ParticleState.zeros(n, device=device).replace(
        pos=t(rng.uniform(-3.9, 3.9, (n, 3))), vel=t(vec(4.0)),
        acc=t(vec(900.0)), density=t(rng.uniform(500.0, 1500.0, n)),
        pressure=t(rng.uniform(0.0, 1e6, n)), foam=t(rng.uniform(0, 0.2, n)),
        ghost=t(ghost, np.int32),
        face=t(np.where(ghost, rng.integers(0, 6, n), -1), np.int32),
        valid=t(rng.uniform(size=n) > 0.05, np.int32))
    cols = [rng.uniform(-3.9, 3.9, (n, 3)), vec(4.0), vec(900.0),
            rng.uniform(400.0, 1600.0, (n, 1))]
    if emit:
        per = t(np.concatenate(cols + [np.zeros((n, 6))], 1))
        npos, nvel, acc, rho = per[:, 0:3], per[:, 3:6], per[:, 6:9], per[:, 9]
    else:
        npos, nvel, acc, rho = (t(c) for c in cols[:3] + [cols[3][:, 0]])
    pres = t(rng.uniform(0.0, 1e6, n))
    params = TP.FluidParams.default(
        device=device, box_half=np.full(3, 3.0, np.float32),
        ghost_face_active=(1, 1, 1, 0, 0, 1), wall_restitution=0.3,
        wall_friction=0.1, foam_vel_ref=4.0).derive_mass()
    return state, (rho, pres, npos, nvel, acc), params


def assert_same_state(got, want):
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        assert torch.equal(g, w), (f.name, int((g != w).sum()))


@pytest.mark.cuda
@pytest.mark.parametrize("emit", [False, True], ids=["columns", "emitted"])
@pytest.mark.parametrize("ghosts", [False, True], ids=["fluid", "ghosts"])
def test_container_pass_bit_identical_to_torch_ops_on_cuda(cuda, ghosts,
                                                          emit):
    """Reassembly alone, the container alone and both in one launch: each
    the plain torch ops on the same CUDA tensors, bit for bit (a box at
    zero Euler angles, whose rotation is exactly the identity)."""
    state, sweep, params = reassembly_inputs(cuda, ghosts, emit)
    trace.reset()
    ra = sweeps.reassemble(state, *sweep, params, ghosts=ghosts)
    torch.cuda.synchronize()
    rp = sweeps.reassemble_plain(state, *sweep, params, ghosts=ghosts)
    assert_same_state(ra, rp)
    ca = constraints.apply_container(rp, params)
    torch.cuda.synchronize()
    cp = constraints.apply_container_plain(rp, params)
    assert_same_state(ca, cp)
    both = sweeps.reassemble(state, *sweep, params, ghosts=ghosts,
                             contain=True)
    torch.cuda.synchronize()
    assert_same_state(both, cp)
    assert trace.counter("launches.container") == 3
    fluid = state.fluid_mask()
    # the cases reach what they claim: foam on fluid rows, rows moved
    assert int((rp.foam > state.foam * 0.995)[fluid].sum()) > 1000
    assert int(((cp.pos != rp.pos).any(-1) & fluid).sum()) > 1000
    if ghosts:
        assert int((rp.density == 1000.0).sum()) > 300


# ---------------------------------------------------------------------------
# fixtures built to break a force kernel's blocking: crowded cells, blocks
# that straddle grid rows, the grid's x edges, no fluid at all, one row
# ---------------------------------------------------------------------------

LATTICE_H = 0.4
LATTICE_HALF = (1.2, 1.2, 1.2)       # grid 8 x 8 x 8, origin -1.6
CROWD_CPU, CROWD_CARD = 300, 2400    # rows in the one crowded cell


QUEUE_EDGE = 30     # rows added to one cell: its rows' neighbor counts lie
                    # on both sides of the force kernel's 32-entry queue
MOVER_SPEED = 0.35  # of h per substep, for a third of the "movers" rows
MOVER_DT = 3e-3     # the "movers" substep: forces move a row 9x further


def _lattice_spawn(cells_xyz, per_cell, seed, crowd=0, crowd_cell=(4, 1, 4)):
    """``per_cell`` jittered rows in each listed cell, and ``crowd`` more
    in ``crowd_cell``."""
    rng = np.random.default_rng(seed)
    gmin = -(np.asarray(LATTICE_HALF, np.float32) + np.float32(LATTICE_H))
    cells_xyz = np.asarray(cells_xyz, np.float32).reshape(-1, 3)
    idx = np.repeat(cells_xyz, per_cell, axis=0)
    idx = np.concatenate([idx, np.tile(np.asarray(crowd_cell, np.float32),
                                       (crowd, 1))])
    pos = gmin + (idx + 0.05 + 0.9 * rng.random(idx.shape)) * LATTICE_H
    pos = pos.astype(np.float32)
    n = pos.shape[0]
    vel = (0.1 * rng.standard_normal((n, 3))).astype(np.float32)
    return TS.SpawnResult(
        pos=pos, vel=vel, ghost=np.zeros((n,), np.int32),
        face=np.full((n,), -1, np.int32),
        color_group=np.zeros((n,), np.int32), count=n)


def _cells(xs, ys, zs):
    return [(x, y, z) for y in ys for z in zs for x in xs]


def blocking_case(name, crowd=CROWD_CPU):
    """(spawn, half, h, active faces) of a fixture named in BLOCKING."""
    full = _cells(range(8), range(3), range(8))
    if name == "full_rows":      # every cell of 24 grid rows, x = 0 and
        spawn = _lattice_spawn(full, 2, 11)        # x = nx - 1 included
    elif name == "straddle":     # 32 rows over four (y, z) grid rows
        spawn = _lattice_spawn(_cells(range(8), (1, 2), (2, 3)), 1, 12)
    elif name == "crowded_cell":   # one cell far beyond any staging buffer
        spawn = _lattice_spawn(full, 2, 13, crowd=crowd)
    elif name == "queue_edge":   # a cell whose rows fill the kernel's queue
        spawn = _lattice_spawn(full, 2, 17, crowd=QUEUE_EDGE)
    elif name == "movers":       # fast rows: the fresh position is far from
        spawn = _lattice_spawn(full, 2, 18)        # the old one
        rng = np.random.default_rng(19)
        d = rng.standard_normal(spawn.vel.shape).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        fast = rng.random(spawn.count) < 1 / 3
        spawn.vel[fast] = (MOVER_SPEED * LATTICE_H / MOVER_DT) * d[fast]
    elif name == "single":       # n = 1
        spawn = _lattice_spawn([(3, 1, 3)], 1, 14)
    elif name == "ragged":       # n = 131: no multiple of any tile
        spawn = _lattice_spawn(full[:131], 1, 15)
    elif name == "no_fluid":     # an empty grid: ghosts only
        spawn = TS.spawn_ghost_box_shell(h=LATTICE_H, box_half=LATTICE_HALF)
    elif name == "crowded_ghost_face":   # the crowded cell against the -Y
        spawn = TS.concat_spawns(                  # face's ghosts
            _lattice_spawn(full, 2, 20, crowd=crowd),
            TS.spawn_ghost_box_shell(h=LATTICE_H, box_half=LATTICE_HALF))
    elif name == "ghosts_some_faces":   # -X, -Y, +Z only
        spawn = TS.concat_spawns(
            _lattice_spawn(full, 2, 16),
            TS.spawn_ghost_box_shell(h=LATTICE_H, box_half=LATTICE_HALF))
        return spawn, LATTICE_HALF, LATTICE_H, (1, 0, 1, 0, 0, 1)
    else:
        raise KeyError(name)
    return spawn, LATTICE_HALF, LATTICE_H, ALL_FACES


BLOCKING = ["full_rows", "straddle", "crowded_cell", "single", "ragged",
            "no_fluid", "ghosts_some_faces", "queue_edge", "movers",
            "crowded_ghost_face"]


def blocking_inputs(name, device="cpu", crowd=CROWD_CPU):
    """The sorted sweep inputs of a blocking fixture with a density made
    from a seed (within 1% of rest, so the crowded cell's pressure forces
    stay of the size the tolerances were set for)."""
    spawn, half, h, active = blocking_case(name, crowd)
    state = TS.state_from_spawn(spawn, device=device)
    params = TP.FluidParams.default(
        device=device, h=h, box_half=np.asarray(half, np.float32),
        ghost_face_active=active).derive_mass()
    dims = TP.compute_grid_dims(TP.SHAPE_BOX, half, (0, 0, 0), h)
    assert dims == (8, 8, 8)
    (key, pos, vel, cs, ce), s, pv, ghosts = sweep_inputs(state, params, dims)
    u = np.random.default_rng(5).random(state.n).astype(np.float32)
    if name == "movers":
        # a fifth of the rows at up to 1.5 rho0 and a long substep: pressure
        # pushes some rows further in it than the kernel's queue margin
        u = np.where(np.random.default_rng(6).random(state.n) < 0.2, 50 * u,
                     u).astype(np.float32)
        pv = pv.replace(dt=float(np.float32(MOVER_DT)))
    rho = torch.where(key < pv.num_cells,
                      torch.as_tensor(1000.0 * (1.0 + 0.01 * u),
                                      device=key.device),
                      torch.zeros((), device=key.device))
    return (key, pos, vel, rho, cs, ce, pv, ghosts), s


def test_blocking_fixtures_are_what_they_claim():
    sizes = {}
    for name in BLOCKING:
        (key, _, _, _, cs, ce, pv, ghosts), s = blocking_inputs(name)
        counts = (ce - cs).numpy().reshape(8, 8, 8)      # [y, z, x]
        sizes[name] = (int((key < pv.num_cells).sum()), int(counts.max()),
                       ghosts is not None)
        if name in ("full_rows", "crowded_cell", "ghosts_some_faces",
                    "crowded_ghost_face"):
            assert (counts[:3] >= 2).all()    # x = 0 and x = 7 occupied
    assert sizes["full_rows"] == (384, 2, False)
    assert sizes["straddle"] == (32, 1, False)
    assert sizes["crowded_cell"] == (384 + CROWD_CPU, 2 + CROWD_CPU, False)
    assert sizes["single"] == (1, 1, False)
    assert sizes["ragged"] == (131, 1, False)
    assert sizes["no_fluid"][:2] == (0, 0) and sizes["no_fluid"][2]
    assert sizes["ghosts_some_faces"] == (384, 2, True)
    assert sizes["queue_edge"] == (384 + QUEUE_EDGE, 2 + QUEUE_EDGE, False)
    assert sizes["movers"] == (384, 2, False)
    assert sizes["crowded_ghost_face"] == (384 + CROWD_CPU, 2 + CROWD_CPU,
                                           True)
    # the crowded cell's rows have active ghosts within h: its warps' ghost
    # ranges carry sources
    (key, pos, _, _, cs, ce, pv, ghosts), s = blocking_inputs(
        "crowded_ghost_face")
    crowd = key == int(torch.argmax(ce - cs))
    assert int(crowd.sum()) == 2 + CROWD_CPU
    assert int((torch.cdist(pos[crowd], ghosts.pos) < pv.h).sum()) > 300


def whole_warps(cs, ce, nx):
    """Aligned groups of 32 rows that lie in one x-run of cells or in two,
    and either the rows of each run are at most ``FORCE_TILE_SPAN`` cells
    apart (first to last) or some row's own three cells of its run hold
    ``FORCE_TILE_CROWD`` rows or more, from the cells' ranges alone."""
    cell = torch.repeat_interleave(torch.arange(cs.shape[0]), ce - cs)
    w = cell[:cell.shape[0] // 32 * 32].reshape(-1, 32)
    count = 0
    for rows in w.tolist():
        runs = {}
        for c in rows:
            runs.setdefault(c // nx, []).append(c % nx)
        narrow = all(max(xs) - min(xs) < sweeps.FORCE_TILE_SPAN
                     for xs in runs.values())
        crowded = any(
            int(ce[c - c % nx + min(c % nx + 1, nx - 1)]
                - cs[c - c % nx + max(c % nx - 1, 0)])
            >= sweeps.FORCE_TILE_CROWD for c in rows)
        count += len(runs) <= 2 and (narrow or crowded)
    return count


@pytest.mark.parametrize("name", BLOCKING)
def test_tile_warp_count_on_blocking_fixtures(name):
    """The force kernel's tile rule, reckoned from the sorted keys: the
    warps whose rows lie in one or two x-runs of cells, each run's within
    the span or a row's three cells crowded (the crowded cells' warps,
    those that straddle the crowded cell and its x neighbours among them,
    and no others: every other cell holds 2 rows, or 1, so any other warp
    spans more cells)."""
    (key, _, _, _, cs, ce, pv, _), _ = blocking_inputs(name)
    got = sweeps.tile_warp_count(key, pv.num_cells, pv.nx)
    assert got == whole_warps(cs, ce, pv.nx)
    if name in ("crowded_cell", "crowded_ghost_face"):
        assert got >= (2 + CROWD_CPU) // 32 - 1 > 0
    elif name != "queue_edge":
        assert got == 0
    counter = torch.zeros(1, dtype=torch.int32)
    sweeps.force_xsph(*blocking_inputs(name)[0], tile_warps=counter)
    assert int(counter) == got


def test_tile_rule_ignores_partial_warps_and_non_fluid_rows():
    """Only whole aligned warps of fluid rows in one x-run of cells or in
    two, each run's rows within ``FORCE_TILE_SPAN`` cells: not a partial
    last warp, not 32 ghost or padding rows (key num_cells), not 32 rows of
    one key that straddle two aligned warps, not a run wider than the span
    (with or without empty cells inside it) unless a row's own three cells
    hold ``FORCE_TILE_CROWD`` rows, not three runs; two runs, as across the
    end of a grid row, are taken."""
    nc, nx, span = 512, 8, sweeps.FORCE_TILE_SPAN

    def count(*groups):
        k = torch.cat([torch.full((m,), c, dtype=torch.int32)
                       for c, m in groups])
        return sweeps.tile_warp_count(k, nc, nx)

    k = torch.tensor([5] * 32 + [7] * 40, dtype=torch.int32)
    assert sweeps.tile_warp_count(k, nc, nx) == 2    # the last 8 are partial
    assert sweeps.tile_warp_count(k[:63], nc, nx) == 1
    assert sweeps.tile_warp_count(k[:31], nc, nx) == 0
    pad = torch.full((64,), nc, dtype=torch.int32)
    assert sweeps.tile_warp_count(torch.cat([k[:32], pad]), nc, nx) == 1
    # 3 | 5 (three cells), then 5 | 9 (one cell in each of two runs)
    assert count((3, 16), (5, 32), (9, 16)) == 1 + (span >= 3)
    pair = torch.tensor([4] * 16 + [5] * 16 + [6] * 20 + [7] * 12,
                        dtype=torch.int32)
    assert sweeps.tile_warp_count(pair, nc, nx) == 2
    assert count((7, 16), (8, 16)) == 1                  # a run's end
    assert count((6, 8), (7, 8), (8, 8), (9, 8)) == 1    # two in each run
    assert count((7, 8), (8, 8), (8 + span, 16)) == 0    # one run too wide
    assert count((4, 10), (5, 12), (6, 10)) == (span >= 3)
    assert count((4, 16), (6, 16)) == (span >= 3)        # an empty cell
    assert count((2, 16), (2 + span - 1, 16)) == 1       # the widest taken
    assert count((2, 16), (2 + span, 16)) == 0
    assert count((7, 10), (8, 12), (16, 10)) == 0        # three runs
    # a run wider than the span, taken when a row's own three cells (x - 1
    # to x + 1) hold the crowd: 3 | 3 | 3, 4, 6 with 6 + 2 over the crowd
    crowd = sweeps.FORCE_TILE_CROWD
    assert count((3, crowd + 6), (4, 2), (6, 33)) == 3
    assert count((3, crowd - 3), (4, 2), (6, 33)) == 2   # 3 | 3, 4, 6 | 6
    assert count((3, crowd + 6), (4, 2), (14, 24)) == 3  # across a run end
    assert count((2, crowd + 6), (4, 2), (9, 8), (17, 16)) == 2
    last = torch.tensor([nc - 1] * 32, dtype=torch.int32)
    assert sweeps.tile_warp_count(last, nc, nx) == 1
    assert sweeps.tile_warp_count(torch.zeros(0, dtype=torch.int32), nc,
                                  nx) == 0
    assert torch.equal(sweeps.tile_warp_mask(pair, nc, nx),
                       torch.tensor([True, True]))


def test_queue_warp_reasons():
    """The warps with a fluid row that the tile rule turns away, by the
    first reason that holds: a non-fluid row or the partial last warp,
    three x-runs or more, a run wider than the span; every other warp
    with a fluid row takes the tile path."""
    nc, nx, span = 512, 8, sweeps.FORCE_TILE_SPAN
    groups = [(4, 32),                              # tile
              (5, 16), (5 + span, 16),              # span
              (15, 10), (16, 12), (24, 10),         # runs
              (30, 32),                             # tile
              (40, 20), (nc, 12),                   # non-fluid
              (nc, 32)]                             # no fluid row
    k = torch.cat([torch.full((m,), c, dtype=torch.int32)
                   for c, m in groups])
    assert sweeps.queue_warp_reasons(k, nc, nx) == {
        "non_fluid": 1, "runs": 1, "span": 1}
    assert sweeps.tile_warp_count(k, nc, nx) == 2
    partial = torch.full((40,), 4, dtype=torch.int32)
    assert sweeps.queue_warp_reasons(partial, nc, nx) == {
        "non_fluid": 1, "runs": 0, "span": 0}
    assert sweeps.queue_warp_reasons(k[:0], nc, nx) == {
        "non_fluid": 0, "runs": 0, "span": 0}


# Crowded cells of the lattice fixture (x, y, z): two side by side in one
# x-run (keys 100 and 101), four in one x-run, two at the end of one x-run
# and the start of the next (keys 95 and 96, seven cells apart in x), and
# two at the end of a z-layer and the start of the next y-layer (keys 127
# and 128, apart in x, y and z).
CROWD_CELLS = {
    "pair": ((4, 1, 4), (5, 1, 4)),
    "row": ((3, 1, 4), (4, 1, 4), (5, 1, 4), (6, 1, 4)),
    "run_end": ((7, 1, 3), (0, 1, 4)),
    "layer_end": ((7, 1, 7), (0, 2, 0)),
}


def pair_cells_inputs(crowd, far=0, device="cpu", cells="pair"):
    """Sweep inputs of crowded cells (``CROWD_CELLS[cells]``; by default two
    side by side in x): 2 rows in every cell of the lower three layers,
    ``crowd`` more in each crowded cell, and ``far`` rows in cell (0, 0,
    0), which shift the others against the warps.  The density is made
    from each row's ``orig_id``, within 1% of rest.  Returns (args, state,
    the crowd's mask)."""
    first, *more = CROWD_CELLS[cells]
    spawn = _lattice_spawn(_cells(range(8), range(3), range(8)), 2, 22,
                           crowd=crowd, crowd_cell=first)
    for seed, cell in enumerate(more, 23):
        spawn = TS.concat_spawns(spawn, _lattice_spawn(
            np.zeros((0, 3)), 0, seed, crowd=crowd, crowd_cell=cell))
    if far:     # after the others, so that their orig_id stay the same
        spawn = TS.concat_spawns(spawn, _lattice_spawn([(0, 0, 0)], far, 21))
    state = TS.state_from_spawn(spawn, device=device)
    params = TP.FluidParams.default(
        device=device, h=LATTICE_H,
        box_half=np.asarray(LATTICE_HALF, np.float32)).derive_mass()
    (key, pos, vel, cs, ce), s, pv, ghosts = sweep_inputs(state, params,
                                                         (8, 8, 8))
    n = spawn.count
    u = torch.as_tensor(np.random.default_rng(5).random(n).astype(
        np.float32), device=device)[s.orig_id.long().clamp(0, n - 1)]
    rho = torch.where(key < pv.num_cells, 1000.0 * (1.0 + 0.01 * u),
                      torch.zeros((), device=device))
    crowd_rows = torch.zeros_like(key, dtype=torch.bool)
    for x, y, z in CROWD_CELLS[cells]:
        crowd_rows |= key == x + 8 * (z + 8 * y)
    return (key, pos, vel, rho, cs, ce, pv, ghosts), s, crowd_rows


def assert_force_matches_all_pairs(args, s):
    """The plain force sweep on ``args`` against the all-pairs one
    (``brute_kernels.force_plain``) on the fluid rows."""
    from sph_tpu_torch.physics import brute_kernels as BK
    key, pos, vel, rho, cs, ce, pv, g = args
    npos, nvel, acc = sweeps.force_xsph(*args)
    m = s.fluid_mask()
    pres = torch.clamp_min(pv.gas_k * (rho - pv.rho0), 0.0)
    want = BK.force_plain(pos, vel, rho, pres, m.float(), pv)
    np.testing.assert_allclose(npos[m], want[0][m], rtol=0, atol=POS_ATOL)
    np.testing.assert_allclose(nvel[m], want[1][m], rtol=0, atol=VEL_ATOL)
    np.testing.assert_allclose(acc[m], want[2][m], rtol=ACC_RTOL,
                               atol=ACC_ATOL)


def test_tile_rule_takes_pairs_of_cells():
    """Two crowded cells side by side in x: the warps that straddle them
    take the tile path too, and so do the two at the crowd's edges, whose
    sparse rows' own three cells hold a crowded one; the rule agrees with
    the cells' ranges, and the plain force sweep there matches the
    all-pairs one."""
    args, s, crowd = pair_cells_inputs(160)
    key, cs, ce, pv = args[0], args[4], args[5], args[6]
    assert int(crowd.sum()) == 2 * 162      # key 100 from row 200 to 362
    mask = sweeps.tile_warp_mask(key, pv.num_cells, pv.nx)
    w = key[:mask.shape[0] * 32].reshape(-1, 32)
    assert int((mask & (w[:, 0] != w[:, -1])).sum()) == 3
    # rows 200 to 524: the 9 aligned warps from row 224 to row 512, and
    # those from rows 192 (keys 96 to 100) and 512 (keys 101 to 111)
    assert int(mask.sum()) == whole_warps(cs, ce, pv.nx) == 11
    assert bool(mask[6:17].all())
    assert_force_matches_all_pairs(args, s)


@pytest.mark.parametrize("cells", ["row", "run_end", "layer_end"])
def test_tile_rule_on_crowded_cells_in_runs(cells):
    """Four crowded cells side by side in one x-run, and two crowded cells
    at the end of one x-run (or z-layer) and the start of the next: every
    aligned warp of their rows takes the tile path, those that straddle
    two cells too, the rule agrees with the cells' ranges, and the plain
    force sweep there matches the all-pairs one."""
    args, s, crowd = pair_cells_inputs(160, far=8, cells=cells)
    key, cs, ce, pv = args[0], args[4], args[5], args[6]
    mask = sweeps.tile_warp_mask(key, pv.num_cells, pv.nx)
    assert int(mask.sum()) == whole_warps(cs, ce, pv.nx)
    rows = torch.nonzero(crowd).flatten()
    inside = torch.arange(-(-int(rows[0]) // 32), (int(rows[-1]) + 1) // 32)
    assert int(crowd.sum()) == 162 * len(CROWD_CELLS[cells])
    assert bool(mask[inside].all())            # the crowd's whole warps
    # the warp across the first two crowded cells: of two runs but in "row"
    x, y, z = CROWD_CELLS[cells][1]
    second = int(torch.nonzero(key == x + 8 * (z + 8 * y))[0])
    w = key[second // 32 * 32:][:32]
    assert second % 32 and bool(mask[second // 32])
    assert (int(w[0]) // pv.nx != int(w[-1]) // pv.nx) == (cells != "row")
    assert_force_matches_all_pairs(args, s)


def test_queue_edge_and_movers_reach_the_kernels_other_paths():
    """What the force kernel's queue is built around (csrc/sweeps.cu): 32
    entries a row, taken within h of the row or within 1.05 h of where its
    velocity alone would carry it, read again for the XSPH pass when the
    forces moved the warp's rows less than 0.045 h from there, emptied on
    the way when a row has more.  ``queue_edge`` has
    rows with more and rows with fewer than 32 such sources; ``movers`` has
    rows that step a third of h and rows on both sides of 0.045 h."""
    from sph_tpu_torch.app.neighbor_counts import reach_counts
    (key, pos, vel, rho, cs, ce, pv, g), s = blocking_inputs("queue_edge")
    m = s.fluid_mask()
    reach = (1 + sweeps.FORCE_MARGIN) * pv.h
    near = (torch.cdist(pos[m], pos[m]) < reach).sum(1)
    # every source in reach lies in the 9 ranges: the script's count (the
    # row itself included) is the all-pairs count
    cand, counted = reach_counts(key, pos, cs, ce, pv, g, reach)
    assert torch.equal(counted, near) and bool((cand >= counted).all())
    q = sweeps.FORCE_QUEUE
    assert int((near - 1 > q).sum()) >= 20 and int((near - 1 < q).sum()) >= 300
    (key, pos, vel, rho, cs, ce, pv, g), s = blocking_inputs("movers")
    npos, _, _ = sweeps.force_xsph(key, pos, vel, rho, cs, ce, pv, g)
    m = s.fluid_mask()
    step = torch.linalg.norm(npos - pos, dim=1)[m]
    off = torch.linalg.norm(npos - (pos + vel * pv.dt * 0.995), dim=1)[m]
    assert int((step > 0.3 * pv.h).sum()) >= 100
    edge = 0.9 * sweeps.FORCE_MARGIN * pv.h
    assert int((off > edge).sum()) >= 20 and int((off < edge).sum()) >= 100


@pytest.mark.parametrize("name", BLOCKING)
def test_force_xsph_plain_matches_all_pairs_on_blocking_fixtures(name):
    """The cell sweep's plain version against the all-pairs plain version
    (``brute_kernels.force_plain``, held to the JAX kernel in
    test_torch_brute.py) on the same rows and densities: every pair within
    h lies in the 9 ranges, at the grid's edges and in a crowded cell too.
    Same tolerances as kernel against plain (the pair order differs)."""
    from sph_tpu_torch.physics import brute_kernels as BK
    (key, pos, vel, rho, cs, ce, pv, ghosts), s = blocking_inputs(name)
    npos, nvel, acc = sweeps.force_xsph(key, pos, vel, rho, cs, ce, pv,
                                        ghosts)
    m = s.fluid_mask()
    assert torch.equal(npos[~m], pos[~m]) and bool((acc[~m] == 0).all())
    if not bool(m.any()):
        return
    # all pairs: fluid rows as they are, contributing ghosts at rho0, P = 0
    src = m.clone()
    rho_all, v_all = rho.clone(), vel.clone()
    if ghosts is not None:
        on = (s.ghost > 0) & s.contrib_mask(
            torch.as_tensor(blocking_case(name)[3]))
        src |= on
        rho_all[on] = pv.rho0
        v_all[on] = 0.0
    pres = torch.clamp_min(pv.gas_k * (rho_all - pv.rho0), 0.0)
    want = BK.force_plain(pos, v_all, rho_all, pres, src.float(), pv)
    np.testing.assert_allclose(npos[m], want[0][m], rtol=0, atol=POS_ATOL)
    np.testing.assert_allclose(nvel[m], want[1][m], rtol=0, atol=VEL_ATOL)
    np.testing.assert_allclose(acc[m], want[2][m], rtol=ACC_RTOL,
                               atol=ACC_ATOL)


def light(pv):
    """The sweep params with 0.4 of the mass: a row with nothing in reach
    but itself (962 at the derived mass) then falls below the floor."""
    return pv.replace(mass=float(np.float32(0.4 * pv.mass)))


@pytest.mark.parametrize("name", BLOCKING)
def test_density_plain_matches_all_pairs_on_blocking_fixtures(name):
    """The density sweep's plain version against the all-pairs plain
    version (``brute_kernels.density_raw_plain``, held to the JAX kernel in
    test_torch_brute.py) with the oracle's floor: every source within h lies
    in the 9 ranges, in a crowded cell, at the grid's faces (clamped block)
    and with ghosts on some faces; a row with nothing in reach but itself
    sits on the floor; non-fluid rows get 0."""
    from sph_tpu_torch.physics import brute_kernels as BK
    (key, pos, _, _, cs, ce, pv, ghosts), s = blocking_inputs(name)
    if name == "single":
        pv = light(pv)
    rho, pres = sweeps.density(key, pos, cs, ce, pv, ghosts)
    m = s.fluid_mask()
    assert bool((rho[~m] == 0).all()) and bool((pres[~m] == 0).all())
    if not bool(m.any()):
        return
    src = m.clone()
    if ghosts is not None:
        src |= (s.ghost > 0) & s.contrib_mask(
            torch.as_tensor(blocking_case(name)[3]))
    raw = BK.density_raw_plain(pos, src.float(), pv)
    want = torch.clamp_min(raw, pv.rho_floor)
    np.testing.assert_allclose(rho[m], want[m], rtol=RHO_RTOL, atol=RHO_ATOL)
    np.testing.assert_allclose(
        pres[m], torch.clamp_min(pv.gas_k * (want[m] - pv.rho0), 0.0),
        rtol=1e-4, atol=RHO_ATOL * pv.gas_k)
    if name == "single":
        assert float(rho[m][0]) == pv.rho_floor
    if name == "crowded_cell":
        assert float(rho.max()) > 50 * pv.rho0


DENSITY_CARD = BLOCKING + ["ghost_shell_all_faces"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", DENSITY_CARD)
def test_density_kernel_on_blocking_fixtures_on_cuda(cuda, name):
    """The density kernel against its plain version on the fixtures built to
    break a kernel's blocking: a cell of 2,400 rows, a lone row (the floor),
    full grid rows at the grid's faces (clamped block), no fluid, ghosts on
    three faces, and the ghost shell with all six faces on; rho and pres
    bit-equal with and without the source records, the records bit-equal to
    the plain packing, and a second launch bit-equal to the first."""
    if name == "ghost_shell_all_faces":
        state, params, dims = port_inputs("ghost_shell", device=cuda)
        (key, pos, vel, cs, ce), _, pv, g = sweep_inputs(state, params, dims)
        assert g is not None and int(g.near.sum()) > 0
    else:
        (key, pos, vel, _, cs, ce, pv, g), _ = blocking_inputs(
            name, device=cuda, crowd=CROWD_CARD)
    if name == "single":
        pv = light(pv)
    trace.reset()
    rho_p, pres_p = sweeps.density_plain(key, pos, cs, ce, pv, g)
    rho, pres = sweeps.density(key, pos, cs, ce, pv, g)
    rho_s, pres_s, src = sweeps.density_sources(key, pos, vel, cs, ce, pv, g)
    again = sweeps.density_sources(key, pos, vel, cs, ce, pv, g)
    torch.cuda.synchronize()
    torch.testing.assert_close(rho, rho_p, rtol=RHO_RTOL, atol=RHO_ATOL)
    torch.testing.assert_close(pres, pres_p, rtol=1e-4,
                               atol=RHO_ATOL * pv.gas_k)
    assert torch.equal(rho_s, rho) and torch.equal(pres_s, pres)
    assert torch.equal(src, sweeps.pack_sources(pos, vel, rho, pv, g))
    for a, b in zip(again, (rho_s, pres_s, src)):
        assert torch.equal(a, b)
    if name == "single":
        assert float(rho[key < pv.num_cells][0]) == pv.rho_floor
    assert trace.counter("launches.density") == 3


@pytest.mark.cuda
@pytest.mark.parametrize("name", BLOCKING)
def test_force_kernels_on_blocking_fixtures_on_cuda(cuda, name):
    """Both force kernels against the plain version on the fixtures built
    to break a kernel's blocking (the crowded cell holds 2,400 rows here),
    the emit variant bit-equal to the other, and a second launch of each
    bit-equal to the first."""
    args, _ = blocking_inputs(name, device=cuda, crowd=CROWD_CARD)
    want = sweeps.force_xsph_plain(*args)
    got = sweeps.force_xsph(*args)
    per = sweeps.force_xsph_emit(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=POS_ATOL)
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=VEL_ATOL)
    torch.testing.assert_close(got[2], want[2], rtol=ACC_RTOL, atol=ACC_ATOL)
    assert torch.equal(per[:, :9], torch.cat(got, 1))
    assert torch.equal(per[:, 9], args[3])
    for a, b in zip(sweeps.force_xsph(*args), got):
        assert torch.equal(a, b)
    assert torch.equal(sweeps.force_xsph_emit(*args), per)


@pytest.mark.cuda
@pytest.mark.parametrize("name", BLOCKING)
def test_force_kernels_count_tile_warps_on_cuda(cuda, name):
    """Each force kernel's counter equals ``tile_warp_count``, and its
    outputs with the counter are bit-equal to those without (the main path
    passes none)."""
    args, _ = blocking_inputs(name, device=cuda, crowd=CROWD_CARD)
    want = sweeps.tile_warp_count(args[0], args[6].num_cells, args[6].nx)
    if name in ("crowded_cell", "crowded_ghost_face"):
        assert want >= (2 + CROWD_CARD) // 32 - 1
    plain = sweeps.force_xsph(*args)
    emit = sweeps.force_xsph_emit(*args)
    counter = torch.zeros(1, dtype=torch.int32, device=cuda)
    got = sweeps.force_xsph(*args, tile_warps=counter)
    assert int(counter) == want
    counter.zero_()
    per = sweeps.force_xsph_emit(*args, tile_warps=counter)
    assert int(counter) == want
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
    assert torch.equal(per, emit)


# Rows added to each crowded cell of pair_cells_inputs where its rows move
# between the kernel's paths as the warps shift: 30 rows a cell, 62 in a
# row's own three cells, under FORCE_TILE_CROWD (the card's 1,202 a cell
# take the tile path whatever the shift).
SHIFT_CROWD = 28


def rows_on_every_path(device, cells, crowd):
    """The crowded cells ``cells`` (``crowd`` rows more each) shifted
    against the warps by 0, 8, 16 and 24 rows put in a far corner cell:
    each launch matches the plain version and counts ``tile_warp_count``
    tile warps, and the crowd's rows are bit-equal across the shifts.
    Returns how many of those rows took the tile path at some shifts and
    not at others, and the tile warps whose rows lie in two cells of one
    x-run or in two x-runs."""
    outs, paths, cells2, runs2 = [], [], 0, 0
    for shift in (0, 8, 16, 24):
        args, s, rows = pair_cells_inputs(crowd, far=shift, device=device,
                                          cells=cells)
        key, pv = args[0], args[6]
        counter = torch.zeros(1, dtype=torch.int32, device=device)
        got = sweeps.force_xsph(*args, tile_warps=counter)
        want = sweeps.force_xsph_plain(*args)
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=POS_ATOL)
        torch.testing.assert_close(got[1], want[1], rtol=0, atol=VEL_ATOL)
        torch.testing.assert_close(got[2], want[2], rtol=ACC_RTOL,
                                   atol=ACC_ATOL)
        assert int(counter) == sweeps.tile_warp_count(key, pv.num_cells,
                                                      pv.nx)
        order = torch.argsort(s.orig_id[rows])
        outs.append(torch.cat(got, 1)[rows][order])
        tile = sweeps.tile_warp_mask(key, pv.num_cells, pv.nx)
        w = key[:32 * tile.shape[0]].reshape(-1, 32)
        two = w[:, 0] // pv.nx != w[:, -1] // pv.nx
        cells2 += int((tile & ~two & (w[:, 0] != w[:, -1])).sum())
        runs2 += int((tile & two).sum())
        row_tile = torch.zeros(key.shape[0], dtype=torch.bool, device=device)
        row_tile[:32 * tile.shape[0]] = tile.repeat_interleave(32)
        paths.append(row_tile[rows][order])
    for got in outs[1:]:
        assert torch.equal(got, outs[0])
    flips = torch.stack(paths).any(0) & ~torch.stack(paths).all(0)
    return int(flips.sum()), cells2, runs2


@pytest.mark.cuda
def test_force_kernel_rows_do_not_depend_on_their_warps_path_on_cuda(cuda):
    """Two crowded cells side by side, shifted against the warps: with 30
    rows a cell their rows move between tile warps of two cells and queue
    warps, with 1,202 between tile warps of one cell, of two and of the
    crowd's edges, and their outputs stay bit-equal (every path adds a
    row's sources in the same order, and a warp of several cells reads no
    source outside a row's own 3 x 3 x 3 block); each launch matches the
    plain version."""
    flips, cells2, _ = rows_on_every_path(cuda, "pair", SHIFT_CROWD)
    assert flips >= 32 and cells2 >= 4
    flips, cells2, _ = rows_on_every_path(cuda, "pair", CROWD_CARD // 2)
    assert cells2 >= 4


@pytest.mark.cuda
@pytest.mark.parametrize("cells", ["row", "run_end", "layer_end"])
def test_force_kernel_rows_across_runs_do_not_depend_on_their_path_on_cuda(
        cuda, cells):
    """Four crowded cells in one x-run, and two at the end of one x-run (or
    z-layer) and the start of the next, shifted against the warps: rows
    move between queue warps and tile warps of two cells and of two
    x-runs, whose second run lies seven cells away in x (and one in y and
    z) from the warp's first row, and their outputs stay bit-equal, with
    30 rows a cell and with 1,202; each launch matches the plain version
    and counts the rule's tile warps."""
    flips, cells2, runs2 = rows_on_every_path(cuda, cells, SHIFT_CROWD)
    assert flips >= 32
    if cells == "row":
        assert cells2 >= 12 and runs2 == 0
    else:
        assert runs2 >= 3
    flips, cells2, runs2 = rows_on_every_path(cuda, cells, CROWD_CARD // 2)
    assert runs2 >= (0 if cells == "row" else 3)
