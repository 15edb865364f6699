"""The all-pairs engine (sph_tpu_torch.physics.brute_kernels), the
counterpart of ``sph_tpu/physics/brute_pallas.py`` (``dam_break_8k``).

CPU: the plain versions against the Pallas kernels themselves, run in
interpret mode as the JAX package runs them on the CPU (kernel #4
through ``brute_pallas._calls``, kernel #5 through ``brute_pallas.substep``),
and 3 ``"brute_kernel"`` substeps against 3 JAX ``"brute_pallas"``
substeps, on a 512-row dam break and on a ghost shell with its top face
off; kernel #4's plain version also against the oracle's
``brute_force.density_pass`` on the tiling inputs.  Rows are compared in
place: neither engine sorts.

CUDA (marker ``cuda``, skipped without a card): each kernel against its
plain version, and the engine on the card against the CPU.  JAX is
imported inside the fixtures that need it, so the CUDA tests also run
where JAX is not installed:

    python -m pytest tests/test_torch_brute.py -q -m cuda --noconftest

Run as a script, the file prints the JAX reference density of a bench
configuration that ``chip_smoke.py`` holds the port's main path to
(``REF_RHO``):

    PYTHONPATH=. python tests/test_torch_brute.py dam_break_8k 64
"""
import dataclasses
import sys

import numpy as np
import pytest
import torch

from sph_tpu_torch.app import configs as TCFG
from sph_tpu_torch.core import state as TS
from sph_tpu_torch.core.convert import params_from_numpy, state_from_numpy
from sph_tpu_torch.core.params import SimConfig
from sph_tpu_torch.engine import step as TSTEP
from sph_tpu_torch.native import build
from sph_tpu_torch.neighbors.sweeps import make_pvec
from sph_tpu_torch.physics import brute_kernels as BK

# tolerances of the plain versions against the Pallas kernels and of the
# kernels against the plain versions (chip_smoke.py): float32 summation
# order differs (lane-reduction tree, warp slices, row chunks)
RHO_RTOL, RHO_ATOL = 1e-5, 1e-2       # tests/test_solver_equivalence.py:49
POS_ATOL = 1e-5
VEL_ATOL = 1e-3
ACC_RTOL, ACC_ATOL = 1e-4, 1e-1       # |acc| is about |g| = 980
# engine against engine over 3 substeps: tests/test_brute_pallas.py:40-42
POS_TOL, VEL_TOL, RHO_TOL = 1e-4, 1e-3, 1.0
N_SUB = 3
OPEN_TOP = (1, 1, 1, 0, 1, 1)         # +Y (face 3) off


def dam_break_case():
    """512 rows in a box of half 4 (tests/test_brute_pallas.py:23-29)."""
    half = (4.0, 4.0, 4.0)
    return TS.spawn_standard(512, h=0.28, box_half=half, seed=0), half, \
        (1, 1, 1, 1, 1, 1)


def ghost_shell_case():
    """256 fluid rows in a box of half 1.5 inside the ghost shell (1,176
    ghosts, 1,536 rows), with the top face off: its ghosts are no
    sources and keep their old values."""
    half = (1.5, 1.5, 1.5)
    spawn = TS.concat_spawns(
        TS.spawn_standard(256, h=0.28, box_half=half, seed=1),
        TS.spawn_ghost_box_shell(h=0.28, box_half=half))
    return spawn, half, OPEN_TOP


def dam_break_2k_case():
    """The 2k dam break of tests/conftest.py."""
    return TS.spawn_standard(2048, seed=7), (7.0, 7.0, 7.0), \
        (1, 1, 1, 1, 1, 1)


CASES = {"dam_break": dam_break_case, "ghost_shell_open_top": ghost_shell_case,
         "dam_break_2k": dam_break_2k_case}
PALLAS_CASES = ["dam_break", "ghost_shell_open_top"]   # interpret mode
CARD_CASES = ["dam_break_2k", "ghost_shell_open_top"]


def case_numpy(case, warm=2):
    """(state, params) as dicts of numpy arrays, and the grid dims, after
    ``warm`` substeps of the port's oracle on the CPU, so velocities and
    densities are non-trivial."""
    spawn, half, active = CASES[case]()
    state = TS.state_from_spawn(spawn, device="cpu")
    from sph_tpu_torch.core.params import FluidParams, compute_grid_dims
    params = FluidParams.default(
        device="cpu", h=0.28, box_half=np.asarray(half, np.float32),
        ghost_face_active=active).derive_mass()
    dims = compute_grid_dims(0, half, (0, 0, 0), 0.28)
    cfg = SimConfig(n=state.n, grid_dims=dims, neighbor_impl="brute")
    state, _ = TSTEP.run_substeps(
        state, params, TSTEP.SceneBuffers.create(cfg, device="cpu"),
        params.dt, warm, cfg)

    def arrays(obj):
        return {f.name: np.asarray(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    return arrays(state), arrays(params), dims


def kernel_inputs(sd, pd, device="cpu"):
    """The port's state and params on ``device`` and the kernels' inputs:
    contrib as float32, the sweep params."""
    ts = state_from_numpy(sd, device=device)
    tp = params_from_numpy(pd, device=device)
    contrib = ts.contrib_mask(tp.ghost_face_active).to(torch.float32)
    return ts, tp, contrib, make_pvec(tp, tp.dt, (0, 0, 0))


# ---------------------------------------------------------------------------
# the plain versions against the Pallas kernels in interpret mode (CPU)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pallas():
    """Per case: the numpy inputs and what JAX brute_pallas gives for
    them — kernel #4's raw density, one substep (kernel #5's outputs on
    the fluid rows) and 3 substeps of run_substeps."""
    import jax.numpy as jnp
    from sph_tpu.core.params import FluidParams as JFP
    from sph_tpu.core.params import SimConfig as JSC
    from sph_tpu.core.state import ParticleState as JPS
    from sph_tpu.engine import step as JSTEP
    from sph_tpu.neighbors.pallas_sweeps import _make_pvec
    from sph_tpu.physics import brute_pallas as JBP

    out = {}
    for case in PALLAS_CASES:
        sd, pd, dims = case_numpy(case)
        js = JPS(**{k: jnp.asarray(v) for k, v in sd.items()})
        jp = JFP(**{k: jnp.asarray(v) for k, v in pd.items()})
        n = js.n
        np_ = -(-n // 128) * 128
        contrib = js.contrib_mask(jp.ghost_face_active).astype(jnp.float32)
        pad = lambda x, fill=0.0: jnp.pad(   # noqa: E731
            x, [(0, np_ - n)] + [(0, 0)] * (x.ndim - 1),
            constant_values=fill)
        rho_raw = JBP._calls(pad(js.pos, 1.0e7), pad(js.vel),
                             pad(js.density), pad(js.pressure),
                             pad(contrib), _make_pvec(jp, jp.dt),
                             interpret=True)[0][:n]
        one = JBP.substep(js, jp, jp.dt)
        cfg = JSC(n=n, grid_dims=dims, neighbor_impl="brute_pallas")
        three, _ = JSTEP.run_substeps(js, jp, JSTEP.SceneBuffers.create(cfg),
                                      jp.dt, N_SUB, cfg)
        as_np = lambda s: {f.name: np.asarray(getattr(s, f.name))  # noqa
                           for f in dataclasses.fields(s)}
        out[case] = dict(sd=sd, pd=pd, dims=dims,
                         rho_raw=np.asarray(rho_raw), one=as_np(one),
                         three=as_np(three))
    return out


@pytest.mark.parametrize("case", PALLAS_CASES)
def test_density_raw_plain_matches_pallas(pallas, case):
    """Kernel #4 over every row, padding and ghosts included."""
    r = pallas[case]
    ts, _, contrib, pv = kernel_inputs(r["sd"], r["pd"])
    got = BK.density_raw_plain(ts.pos, contrib, pv)
    np.testing.assert_allclose(got.numpy(), r["rho_raw"], rtol=RHO_RTOL,
                               atol=RHO_ATOL)
    assert float(got.max()) > 500.0


@pytest.mark.parametrize("case", PALLAS_CASES)
def test_force_plain_matches_pallas(pallas, case):
    """Kernel #5 on the fluid rows, fed the densities and pressures of
    the same JAX substep."""
    r = pallas[case]
    ts, _, contrib, pv = kernel_inputs(r["sd"], r["pd"])
    one = r["one"]
    npos, nvel, acc = BK.force_plain(
        ts.pos, ts.vel, torch.tensor(one["density"]),
        torch.tensor(one["pressure"]), contrib, pv)
    fl = (r["sd"]["valid"] > 0) & (r["sd"]["ghost"] == 0)
    np.testing.assert_allclose(npos.numpy()[fl], one["pos"][fl], rtol=0,
                               atol=POS_ATOL)
    np.testing.assert_allclose(nvel.numpy()[fl], one["vel"][fl], rtol=0,
                               atol=VEL_ATOL)
    np.testing.assert_allclose(acc.numpy()[fl], one["acc"][fl],
                               rtol=ACC_RTOL, atol=ACC_ATOL)


@pytest.mark.parametrize("case", PALLAS_CASES)
def test_engine_matches_pallas(pallas, case):
    """3 substeps of ``"brute_kernel"`` against 3 of JAX
    ``"brute_pallas"``, over every row, in place."""
    r = pallas[case]
    ts, tp, _, _ = kernel_inputs(r["sd"], r["pd"])
    cfg = SimConfig(n=ts.n, grid_dims=r["dims"], neighbor_impl="brute_kernel")
    got, _ = TSTEP.run_substeps(
        ts, tp, TSTEP.SceneBuffers.create(cfg, device="cpu"), tp.dt, N_SUB,
        cfg)
    want = r["three"]
    for f, tol in (("pos", POS_TOL), ("vel", VEL_TOL),
                   ("density", RHO_TOL)):
        err = float(np.abs(getattr(got, f).numpy() - want[f]).max())
        assert err < tol, (f, err)
    np.testing.assert_array_equal(got.orig_id.numpy(), want["orig_id"])
    g = r["sd"]["ghost"] > 0
    assert g.any() == case.startswith("ghost")
    if g.any():
        on = g & got.contrib_mask(tp.ghost_face_active).numpy()
        assert 0 < on.sum() < g.sum()
        assert np.all(got.vel.numpy()[g] == 0.0)
        assert np.all(got.density.numpy()[on] == 1000.0)
        np.testing.assert_array_equal(got.pos.numpy()[g], r["sd"]["pos"][g])


def test_engine_matches_the_ports_oracle():
    """``"brute_kernel"`` against the port's ``"brute"`` over 10 substeps
    of the ghost shell, with no JAX."""
    sd, pd, dims = case_numpy("ghost_shell_open_top", warm=0)
    outs = {}
    for impl in ("brute", "brute_kernel"):
        ts, tp, _, _ = kernel_inputs(sd, pd)
        cfg = SimConfig(n=ts.n, grid_dims=dims, neighbor_impl=impl)
        outs[impl], _ = TSTEP.run_substeps(
            ts, tp, TSTEP.SceneBuffers.create(cfg, device="cpu"), tp.dt, 10,
            cfg)
    for f, tol in (("pos", POS_TOL), ("vel", VEL_TOL),
                   ("density", RHO_TOL)):
        err = float((getattr(outs["brute"], f)
                     - getattr(outs["brute_kernel"], f)).abs().max())
        assert err < tol, (f, err)


def test_dam_break_8k_builds_bit_identical():
    from sph_tpu.app import configs as JCFG
    ts, tp, tcfg = TCFG.build("dam_break_8k", device="cpu")
    js, jp, jcfg = JCFG.build(JCFG.CONFIGS["dam_break_8k"])
    assert int(ts.fluid_mask().sum()) == jcfg.n_fluid == 8192
    assert tcfg.n == jcfg.n == 8192
    assert tcfg.grid_dims == jcfg.grid_dims == (56, 56, 56)
    assert tcfg.neighbor_impl == "brute_kernel"
    assert jcfg.neighbor_impl == "brute_pallas"
    assert float(tp.surface_tension) == 0.0
    for f in dataclasses.fields(js):
        np.testing.assert_array_equal(getattr(ts, f.name).numpy(),
                                      np.asarray(getattr(js, f.name)),
                                      err_msg=f.name)
    for f in dataclasses.fields(jp):
        if f.name != "shape_type":
            np.testing.assert_allclose(np.asarray(getattr(tp, f.name)),
                                       np.asarray(getattr(jp, f.name)),
                                       rtol=1e-6, err_msg=f.name)


def test_wrappers_on_cpu_take_plain_path_without_counting():
    sd, pd, _ = case_numpy("dam_break", warm=0)
    ts, _, contrib, pv = kernel_inputs(sd, pd)
    BK.reset_launches()
    rho = BK.density_raw(ts.pos, contrib, pv)
    assert torch.equal(rho, BK.density_raw_plain(ts.pos, contrib, pv))
    pres = torch.zeros_like(rho)
    got = BK.force(ts.pos, ts.vel, rho, pres, contrib, pv)
    want = BK.force_plain(ts.pos, ts.vel, rho, pres, contrib, pv)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert BK.LAUNCHES == {"brute_density": 0, "brute_force": 0}


def test_wrappers_reject_other_devices():
    sd, pd, _ = case_numpy("dam_break", warm=0)
    ts, _, contrib, pv = kernel_inputs(sd, pd)
    pos, vel, c = (t.to("meta") for t in (ts.pos, ts.vel, contrib))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        BK.density_raw(pos, c, pv)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        BK.force(pos, vel, c, c, c, pv)


def test_substep_feeds_the_kernels_what_they_take(monkeypatch):
    """The substep's kernel inputs pass the wrappers' CUDA checks (dtype,
    shape, contiguity), checked here on the CPU."""
    seen = []

    def checked(plain, names):
        def run(*args):
            n = args[0].shape[0]
            for name, t in zip(names, args):
                shape = (n, 3) if name in ("pos", "vel") else (n,)
                build.check_tensor(name, t, torch.float32, shape, t.device)
            seen.append(plain.__name__)
            return plain(*args)
        return run

    monkeypatch.setattr(BK, "density_raw_plain", checked(
        BK.density_raw_plain, ("pos", "contrib")))
    monkeypatch.setattr(BK, "force_plain", checked(
        BK.force_plain, ("pos", "vel", "rho", "pres", "contrib")))
    sd, pd, dims = case_numpy("ghost_shell_open_top", warm=0)
    ts, tp, _, _ = kernel_inputs(sd, pd)
    cfg = SimConfig(n=ts.n, grid_dims=dims, neighbor_impl="brute_kernel")
    TSTEP.run_substeps(ts, tp, TSTEP.SceneBuffers.create(cfg, device="cpu"),
                       tp.dt, 2, cfg)
    assert seen == ["density_raw_plain", "force_plain"] * 2


@pytest.mark.parametrize("case", ["dam_break", "ghost_shell_open_top"])
def test_run_substeps_derives_the_sweep_params_once(monkeypatch, case):
    """``run_substeps`` brings the kernels' constants to the host once, before
    its loop (``make_pvec`` waits for the device), and its state is
    bit-equal to as many calls of ``brute_kernels.substep`` that each derive
    them, with the container pass after each."""
    from sph_tpu_torch.physics import constraints
    calls = []
    real = BK.make_pvec

    def counted(*args):
        calls.append(args[2])
        return real(*args)

    monkeypatch.setattr(BK, "make_pvec", counted)
    sd, pd, dims = case_numpy(case, warm=1)
    ts, tp, _, _ = kernel_inputs(sd, pd)
    cfg = SimConfig(n=ts.n, grid_dims=dims, neighbor_impl="brute_kernel")
    got, _ = TSTEP.run_substeps(
        ts, tp, TSTEP.SceneBuffers.create(cfg, device="cpu"), tp.dt, 4, cfg)
    assert calls == [(0, 0, 0)]
    del calls[:]
    want = ts
    for _ in range(4):
        want = constraints.apply_container(BK.substep(want, tp, tp.dt), tp)
    assert len(calls) == 4
    for f in dataclasses.fields(got):
        assert torch.equal(getattr(got, f.name), getattr(want, f.name)), f.name
    # the prepared params are what a substep derives for itself
    assert BK.prepare(tp, tp.dt) == real(tp, tp.dt, (0, 0, 0))
    assert TSTEP.neighbor_aux(ts, tp, tp.dt, cfg) == BK.prepare(tp, tp.dt)
    assert TSTEP.neighbor_aux(ts, tp, tp.dt, dataclasses.replace(
        cfg, neighbor_impl="brute")) is None


# ---------------------------------------------------------------------------
# kernels against the plain versions (CUDA only)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the all-pairs kernels have no CPU "
                    "mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES)
def test_kernels_match_plain_on_cuda(cuda, case):
    sd, pd, _ = case_numpy(case)
    ts, tp, contrib, pv = kernel_inputs(sd, pd, device=cuda)
    BK.reset_launches()
    got = BK.density_raw(ts.pos, contrib, pv)
    want = BK.density_raw_plain(ts.pos, contrib, pv)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=RHO_RTOL, atol=RHO_ATOL)
    from sph_tpu_torch.physics import common as C
    rho, pres = C.finish_density(want, ts.ghost,
                                 ts.contrib_mask(tp.ghost_face_active),
                                 ts.density, ts.pressure, tp)
    got = BK.force(ts.pos, ts.vel, rho, pres, contrib, pv)
    want = BK.force_plain(ts.pos, ts.vel, rho, pres, contrib, pv)
    torch.cuda.synchronize()
    fl = ts.fluid_mask()
    torch.testing.assert_close(got[0][fl], want[0][fl], rtol=0,
                               atol=POS_ATOL)
    torch.testing.assert_close(got[1][fl], want[1][fl], rtol=0,
                               atol=VEL_ATOL)
    torch.testing.assert_close(got[2][fl], want[2][fl], rtol=ACC_RTOL,
                               atol=ACC_ATOL)
    assert BK.LAUNCHES == {"brute_density": 1, "brute_force": 1}


@pytest.mark.cuda
def test_kernel_wrappers_check_inputs_on_cuda(cuda):
    sd, pd, _ = case_numpy("ghost_shell_open_top")
    ts, _, contrib, pv = kernel_inputs(sd, pd, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        BK.density_raw(ts.pos, contrib.double(), pv)
    with pytest.raises(ValueError, match="contiguous"):
        BK.density_raw(ts.pos.t().contiguous().t(), contrib, pv)
    with pytest.raises(ValueError, match="shape"):
        BK.density_raw(ts.pos, contrib[:-1], pv)
    with pytest.raises(ValueError, match="is on"):
        BK.force(ts.pos, ts.vel, ts.density.cpu(), ts.pressure, contrib, pv)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES)
def test_engine_on_cuda_matches_cpu(cuda, case):
    """20 substeps through the kernels against 20 through the plain
    versions, rows in place."""
    sd, pd, dims = case_numpy(case)
    outs = {}
    for dev in ("cpu", cuda):
        ts, tp, _, _ = kernel_inputs(sd, pd, device=dev)
        BK.reset_launches()
        cfg = SimConfig(n=ts.n, grid_dims=dims, neighbor_impl="brute_kernel")
        st, _ = TSTEP.run_substeps(
            ts, tp, TSTEP.SceneBuffers.create(cfg, device=dev), tp.dt, 20,
            cfg)
        outs[str(dev)] = {f: getattr(st, f).cpu()
                          for f in ("pos", "vel", "density")}
    assert BK.LAUNCHES == {"brute_density": 20, "brute_force": 20}
    ref, got = outs["cpu"], outs["cuda"]
    for f, tol in (("pos", POS_TOL), ("vel", VEL_TOL), ("density", RHO_TOL)):
        err = float((got[f] - ref[f]).abs().max())
        assert err < tol, (f, err)


# ---------------------------------------------------------------------------
# inputs built to break the force kernel's tiling: dead sources, two
# coincident rows, row counts that fill no tile
# ---------------------------------------------------------------------------

DEAD_RHO, DEAD_CONTRIB, TWINS = (3, 7), (5,), (10, 11)


def tiling_inputs(n, device="cpu", seed=21):
    """(pos, vel, rho, pres, contrib, pv) of ``n`` rows scattered so that
    each has dozens of neighbors, densities within 5% of rest.  From 16
    rows up: rows 3 and 7 have rho = 0, row 5 has contrib = 0 (dead
    sources all three), and row 11 lies exactly on row 10."""
    from sph_tpu_torch.core.params import FluidParams
    rng = np.random.default_rng(seed)
    side = 0.28 * max(1.0, (n / 12.0) ** (1.0 / 3.0))
    pos = (side * rng.random((n, 3))).astype(np.float32)
    vel = (0.2 * rng.standard_normal((n, 3))).astype(np.float32)
    rho = (1000.0 * (1.0 + 0.05 * rng.random(n))).astype(np.float32)
    contrib = np.ones(n, np.float32)
    if n >= 16:
        rho[list(DEAD_RHO)] = 0.0
        contrib[list(DEAD_CONTRIB)] = 0.0
        pos[TWINS[1]] = pos[TWINS[0]]
    params = FluidParams.default(device=device).derive_mass()
    pv = make_pvec(params, params.dt, (0, 0, 0))
    pres = np.maximum(pv.gas_k * (rho - pv.rho0), 0.0).astype(np.float32)
    return tuple(torch.as_tensor(a, device=device)
                 for a in (pos, vel, rho, pres, contrib)) + (pv,)


# the force kernel takes 64 rows to a block, the density kernel 128 to a
# cluster of two blocks; both 32 sources to a tile
TILING_N = [1, 31, 65, 100, 777]


def jax_density_raw(pos, contrib):
    """``sph_tpu.physics.brute_force.density_pass`` (the JAX oracle's raw
    density, self included) on the same numpy arrays, with the params that
    ``tiling_inputs`` derives its sweep params from."""
    import jax.numpy as jnp
    from sph_tpu.core.params import FluidParams as JFP
    from sph_tpu.physics import brute_force as JBF
    from sph_tpu_torch.core.params import FluidParams
    tp = FluidParams.default(device="cpu").derive_mass()
    jp = JFP(**{f.name: jnp.asarray(np.asarray(getattr(tp, f.name)))
                for f in dataclasses.fields(tp)})
    p = jnp.asarray(pos.numpy())
    return np.asarray(JBF.density_pass(p, p, jnp.asarray(contrib.numpy()), jp))


@pytest.mark.parametrize("n", TILING_N)
def test_density_plain_on_tiling_inputs(n):
    """Kernel #4's plain version against the JAX oracle's density pass on
    the inputs the CUDA cases use: a source with contrib 0, two rows with
    rho = 0 (still sources here), a coincident pair, row counts that fill
    no block or tile."""
    pos, _, _, _, contrib, pv = tiling_inputs(n)
    got = BK.density_raw_plain(pos, contrib, pv)
    np.testing.assert_allclose(got.numpy(), jax_density_raw(pos, contrib),
                               rtol=RHO_RTOL, atol=RHO_ATOL)
    # every row is its own source at r = 0: mass * poly6 * h^6 at least
    assert float(got.min()) >= 0.999 * pv.mass * pv.poly6 * pv.h2 ** 3


def test_density_plain_weights_sources_by_contrib_alone():
    """The density pass weights a source by contrib_j and reads no rho:
    moving the contrib = 0 row changes no other row's raw density, bit for
    bit, while moving a row with rho = 0 and contrib = 1 changes its
    neighbors'.  A coincident twin counts as a source of its own."""
    pos, _, rho, _, contrib, pv = tiling_inputs(100)
    (dead,), live_rho0 = DEAD_CONTRIB, DEAD_RHO[0]
    assert float(contrib[dead]) == 0.0 and float(rho[live_rho0]) == 0.0
    assert float(contrib[live_rho0]) == 1.0
    base = BK.density_raw_plain(pos, contrib, pv)
    others = torch.arange(100) != dead
    moved = pos.clone()
    moved[dead] += 100.0
    assert torch.equal(BK.density_raw_plain(moved, contrib, pv)[others],
                       base[others])
    moved = pos.clone()
    moved[live_rho0] += 100.0
    changed = BK.density_raw_plain(moved, contrib, pv) != base
    changed[live_rho0] = False
    assert bool(changed.any())
    twin = contrib.clone()
    twin[TWINS[1]] = 0.0
    alone = BK.density_raw_plain(pos, twin, pv)
    poly6_h6 = pv.mass * pv.poly6 * pv.h2 ** 3
    torch.testing.assert_close(base[TWINS[0]] - alone[TWINS[0]],
                               torch.tensor(poly6_h6), rtol=1e-4, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", TILING_N)
def test_density_kernel_on_tiling_inputs_on_cuda(cuda, n):
    """The density kernel against its plain version with a contrib = 0
    source, rho = 0 sources, a coincident pair and row counts that fill no
    block or tile; a second launch is bit-equal to the first."""
    pos, _, _, _, contrib, pv = tiling_inputs(n, device=cuda)
    want = BK.density_raw_plain(pos, contrib, pv)
    BK.reset_launches()
    got = BK.density_raw(pos, contrib, pv)
    again = BK.density_raw(pos, contrib, pv)
    torch.cuda.synchronize()
    assert BK.LAUNCHES["brute_density"] == 2
    torch.testing.assert_close(got, want, rtol=RHO_RTOL, atol=RHO_ATOL)
    assert torch.equal(got, again)


@pytest.mark.parametrize("n", TILING_N)
def test_force_plain_on_tiling_inputs(n):
    """The plain version on the inputs the CUDA cases use: finite, a lone
    row falls freely, and a dead source's position and velocity are never
    read (moving it changes no other row, bit for bit)."""
    pos, vel, rho, pres, contrib, pv = tiling_inputs(n)
    out = BK.force_plain(pos, vel, rho, pres, contrib, pv)
    assert all(bool(torch.isfinite(t).all()) for t in out)
    if n == 1:
        g = torch.tensor([pv.gx, pv.gy, pv.gz])
        torch.testing.assert_close(out[2][0], g, rtol=1e-6, atol=0)
        return
    live = (rho > 0) & (contrib > 0)
    assert int((~live).sum()) == (3 if n >= 16 else 0)
    if n < 16:
        return
    pos2, vel2 = pos.clone(), vel.clone()
    pos2[~live] += 100.0
    vel2[~live] = 7.0
    moved = BK.force_plain(pos2, vel2, rho, pres, contrib, pv)
    for a, b in zip(out, moved):
        assert torch.equal(a[live], b[live])


def test_force_plain_counts_a_coincident_row():
    """Two distinct rows at one position are neighbors at r = 0: no
    pressure or viscosity gradient, but the twin weighs in the XSPH sum,
    so taking it away changes the row's velocity.  The self pair is
    excluded by row index, not by distance."""
    pos, vel, rho, pres, contrib, pv = tiling_inputs(100)
    with_twin = BK.force_plain(pos, vel, rho, pres, contrib, pv)
    contrib2 = contrib.clone()
    contrib2[TWINS[1]] = 0.0
    without = BK.force_plain(pos, vel, rho, pres, contrib2, pv)
    assert bool(torch.isfinite(with_twin[1][TWINS[0]]).all())
    assert not torch.equal(with_twin[1][TWINS[0]], without[1][TWINS[0]])


@pytest.mark.cuda
@pytest.mark.parametrize("n", TILING_N)
def test_force_kernel_on_tiling_inputs_on_cuda(cuda, n):
    """The force kernel against its plain version with dead sources, a
    coincident pair and row counts that fill no block or tile; a second
    launch is bit-equal to the first."""
    pos, vel, rho, pres, contrib, pv = tiling_inputs(n, device=cuda)
    want = BK.force_plain(pos, vel, rho, pres, contrib, pv)
    BK.reset_launches()
    got = BK.force(pos, vel, rho, pres, contrib, pv)
    again = BK.force(pos, vel, rho, pres, contrib, pv)
    torch.cuda.synchronize()
    assert BK.LAUNCHES["brute_force"] == 2
    # a row with rho = 0 divides by 1e-12: its own outputs are of the order
    # of 1e12 in both versions and the engine discards them (such a row is
    # no fluid row), so the absolute tolerances hold the other rows
    m = rho > 0
    torch.testing.assert_close(got[0][m], want[0][m], rtol=0, atol=POS_ATOL)
    torch.testing.assert_close(got[1][m], want[1][m], rtol=0, atol=VEL_ATOL)
    torch.testing.assert_close(got[2][m], want[2][m], rtol=ACC_RTOL,
                               atol=ACC_ATOL)
    assert all(bool(torch.isfinite(t).all()) for t in got)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the JAX reference density of a bench configuration
# ---------------------------------------------------------------------------

def jax_reference_density(name: str, n_substeps: int, seed: int = 0,
                          impl: str = "brute", every: int = 16):
    """Fluid density (max, mean) of ``sph_tpu`` at ``name`` after each
    ``every`` substeps up to ``n_substeps``, on the CPU."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from sph_tpu.app import configs as JCFG
    from sph_tpu.engine import step as JSTEP

    state, params, cfg = JCFG.build(JCFG.CONFIGS[name], seed=seed,
                                    neighbor_impl=impl)
    buf = JSTEP.SceneBuffers.create(cfg)
    fluid = (np.asarray(state.valid) > 0) & (np.asarray(state.ghost) == 0)
    rows = []
    for done in range(every, n_substeps + 1, every):
        state, buf = JSTEP.run_substeps(state, params, buf, params.dt,
                                        every, cfg)
        rho = np.asarray(state.density)[fluid]
        rows.append((done, float(rho.max()),
                     float(rho.astype(np.float64).mean())))
    return rows


if __name__ == "__main__":
    for done, rho_max, rho_mean in jax_reference_density(
            sys.argv[1], int(sys.argv[2])):
        print(f"{sys.argv[1]} substep {done}: fluid density max "
              f"{rho_max!r} mean {rho_mean!r}", flush=True)
