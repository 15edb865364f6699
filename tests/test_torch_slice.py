"""The port's main path as a whole: ``engine.step.run_substeps`` with the
``"cell"`` engine against ``sph_tpu`` (``"brute"``, ``"cell"`` and, with
ghost walls, ``"binned"``), the bench configurations, and the guards (no
JAX import, unported parts raise)."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sph_tpu.app import configs as JCFG
from sph_tpu.core import params as JP
from sph_tpu.core import state as JS
from sph_tpu.engine import step as JSTEP
from sph_tpu_torch.app import configs as TCFG
from sph_tpu_torch.core.convert import params_from_numpy, state_from_numpy
from sph_tpu_torch.core.params import SimConfig
from sph_tpu_torch.engine import step as TSTEP


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
N_SUB = 20
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def to_numpy(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def jax_run(state, params, dims, impl, n_sub):
    cfg = JP.SimConfig(n=state.n, grid_dims=dims, neighbor_impl=impl)
    out, _ = JSTEP.run_substeps(state, params, JSTEP.SceneBuffers.create(cfg),
                                params.dt, n_sub, cfg)
    return to_numpy(out)


def port_run(state, params, dims, n_sub):
    """The port's cell engine on the same numpy inputs as ``jax_run``."""
    ts = state_from_numpy(to_numpy(state), device="cpu")
    tp = params_from_numpy(to_numpy(params), device="cpu")
    cfg = SimConfig(n=ts.n, grid_dims=dims)
    out, _ = TSTEP.run_substeps(
        ts, tp, TSTEP.SceneBuffers.create(cfg, device="cpu"), tp.dt, n_sub,
        cfg)
    return {f.name: getattr(out, f.name).numpy()
            for f in dataclasses.fields(out)}


def realigned_errors(ref, got, ghost_density=True):
    """Max abs differences over valid rows, after aligning by orig_id.
    ``ghost_density=False`` leaves the ghost rows out of the density."""
    ia = np.argsort(ref["orig_id"], kind="stable")
    ib = np.argsort(got["orig_id"], kind="stable")
    v = ref["valid"][ia] > 0
    assert np.array_equal(got["valid"][ib] > 0, v)
    rows = {f: v for f in ("pos", "vel", "density")}
    if not ghost_density:
        rows["density"] = v & (ref["ghost"][ia] == 0)
    return {f: float(np.abs(ref[f][ia][m] - got[f][ib][m]).max())
            for f, m in rows.items()}


def crowded_state():
    """48 adjacent cells with 9-12 particles each, more than the JAX
    cell engines' capacity of 8 (see tests/test_torch_sweeps.py)."""
    half, h = (3.0, 3.0, 3.0), 0.4
    params = JP.FluidParams.default(
        h=h, box_half=np.asarray(half, np.float32)).derive_mass()
    gmin = np.asarray(JP.grid_min(params))
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
    state = JS.state_from_spawn(JS.SpawnResult(
        pos=pos, vel=np.zeros((n, 3), np.float32),
        ghost=np.zeros((n,), np.int32), face=np.full((n,), -1, np.int32),
        color_group=np.zeros((n,), np.int32), count=n))
    return state, params, JP.compute_grid_dims(0, half, (0, 0, 0), h)


OPEN_TOP = (1, 1, 1, 0, 1, 1)   # +Y (face 3) off


def ghost_shell_state(active=(1, 1, 1, 1, 1, 1)):
    """512 fluid particles in a box of half 3 inside the ghost shell (as
    tests/test_pallas_engine.py:46-69), moved into the -X, -Y, -Z corner
    so that the walls' ghosts are within h of the fluid from the start."""
    half, h = (3.0, 3.0, 3.0), 0.28
    fluid = JS.spawn_standard(512, h=h, box_half=half, seed=1)
    fluid.pos += np.asarray([-0.35, -0.2, -0.35], np.float32)
    state = JS.state_from_spawn(JS.concat_spawns(
        fluid, JS.spawn_ghost_box_shell(h=h, box_half=half)))
    params = JP.FluidParams.default(
        h=h, box_half=np.asarray(half, np.float32),
        ghost_face_active=np.asarray(active, np.int32)).derive_mass()
    return state, params, JP.compute_grid_dims(0, half, (0, 0, 0), h)


@pytest.fixture(scope="module")
def runs(dam_break_small):
    state, params, dims = dam_break_small
    crowd = crowded_state()
    ghost = ghost_shell_state()
    ghost_open = ghost_shell_state(OPEN_TOP)
    return {
        "jax_brute": jax_run(state, params, dims, "brute", N_SUB),
        "jax_cell": jax_run(state, params, dims, "cell", N_SUB),
        "port_cell": port_run(state, params, dims, N_SUB),
        "crowd_jax_brute": jax_run(*crowd, "brute", N_SUB),
        "crowd_port_cell": port_run(*crowd, N_SUB),
        "ghost_jax_brute": jax_run(*ghost, "brute", N_SUB),
        "ghost_jax_binned": jax_run(*ghost, "binned", N_SUB),
        "ghost_port_cell": port_run(*ghost, N_SUB),
        "open_jax_brute": jax_run(*ghost_open, "brute", N_SUB),
        "open_port_cell": port_run(*ghost_open, N_SUB),
    }


@pytest.mark.parametrize("ref,got", [
    ("jax_brute", "port_cell"),
    ("jax_cell", "port_cell"),
    ("crowd_jax_brute", "crowd_port_cell"),
    ("ghost_jax_brute", "ghost_port_cell"),
    ("ghost_jax_binned", "ghost_port_cell"),
    ("open_jax_brute", "open_port_cell"),
])
def test_cell_engine_matches_reference(runs, ref, got):
    # the JAX binned engine keeps every ghost's old density where the
    # oracle sets rho0 (ROADMAP R7), so its ghost rows' density is not
    # compared; test_ghost_rows_follow_the_oracle checks them
    err = realigned_errors(runs[ref], runs[got],
                           ghost_density=not ref.endswith("binned"))
    assert err["pos"] < POS_TOL, err
    assert err["vel"] < VEL_TOL, err
    assert err["density"] < RHO_TOL, err


@pytest.mark.parametrize("case,active", [("ghost", (1, 1, 1, 1, 1, 1)),
                                         ("open", OPEN_TOP)])
def test_ghost_rows_follow_the_oracle(runs, case, active):
    """Ghosts never move; a ghost on an active face ends with v = 0,
    acc = 0, rho0 and P = 0; one on an inactive face keeps its old values
    (the spawn's zeros), as brute_force.substep does (ROADMAP R7)."""
    start, _, _ = ghost_shell_state(active)
    got = runs[f"{case}_port_cell"]
    ib = np.argsort(got["orig_id"])
    g = np.asarray(start.ghost) > 0
    np.testing.assert_array_equal(got["pos"][ib][g], np.asarray(start.pos)[g])
    on = g & (np.asarray(active)[np.clip(np.asarray(start.face), 0, 5)] > 0)
    off = g & ~on
    assert on.sum() > 0 and (off.sum() > 0) == (case == "open")
    for f in ("vel", "acc", "pressure"):
        assert np.all(got[f][ib][g] == 0.0), f
    assert np.all(got["density"][ib][on] == 1000.0)
    assert np.all(got["density"][ib][off] == 0.0)
    # the fluid did meet the walls: some fluid row is within h of a ghost
    fl = ~g & (np.asarray(start.valid) > 0)
    p = got["pos"][ib]
    near = np.abs(p[fl]).max(axis=1) > 3.0 + 0.45 * 0.28 - 0.28
    assert near.sum() > 50


def test_ghosts_reach_the_fluid():
    """A wall-adjacent fluid particle sees the ghost shell's density only
    while its faces are active, and matches the JAX oracle either way
    (tests/test_binned.py:54-70)."""
    half = (3.0, 3.0, 3.0)
    shell = JS.spawn_ghost_box_shell(box_half=half, layers=2)
    fluid = JS.SpawnResult(
        pos=np.array([[0.0, -2.9, 0.0]], np.float32),
        vel=np.zeros((1, 3), np.float32),
        ghost=np.zeros(1, np.int32), face=np.full(1, -1, np.int32),
        color_group=np.zeros(1, np.int32), count=1)
    st = JS.state_from_spawn(JS.concat_spawns(fluid, shell))
    dims = JP.compute_grid_dims(0, np.asarray(half), np.zeros(3), 0.28)
    rho = {}
    for faces in (1, 0):
        params = JP.FluidParams.default(
            box_half=np.asarray(half, np.float32),
            ghost_face_active=np.full(6, faces, np.int32)).derive_mass()
        want = jax_run(st, params, dims, "brute", 1)
        got = port_run(st, params, dims, 1)
        ia, ib = np.argsort(want["orig_id"]), np.argsort(got["orig_id"])
        rho[faces] = got["density"][ib][0]
        np.testing.assert_allclose(rho[faces], want["density"][ia][0],
                                   rtol=1e-5)
    assert rho[1] > rho[0] + 1.0, rho


def test_cell_engine_keeps_identity_and_flags(runs):
    got = runs["port_cell"]
    assert sorted(got["orig_id"].tolist()) == list(range(len(got["orig_id"])))
    ref = runs["jax_brute"]
    ia, ib = np.argsort(ref["orig_id"]), np.argsort(got["orig_id"])
    for f in ("ghost", "valid", "face", "color_group", "active"):
        np.testing.assert_array_equal(got[f][ib], ref[f][ia], err_msg=f)
    v = ref["valid"][ia] > 0
    assert np.abs(got["foam"][ib][v] - ref["foam"][ia][v]).max() < 1e-4


def test_stability_invariants(dam_break_small):
    """As tests/test_solver_equivalence.py:52-65, on the port alone."""
    state, params, dims = dam_break_small
    st = port_run(state, params, dims, 100)
    v = st["valid"] > 0
    pos, vel, rho = st["pos"][v], st["vel"][v], st["density"][v]
    assert not np.isnan(pos).any()
    assert rho.min() >= 0.5 * 1000.0 - 1e-3
    cap = 0.4 * 0.28 / 1e-3
    assert np.linalg.norm(vel, axis=-1).max() <= cap * 1.0001
    assert np.all(np.abs(pos) <= 7.0 + 1e-4)
    assert st["pressure"][v].min() >= 0.0


def padded_state():
    """512 fluid rows in a box of half 4 (tests/test_brute_pallas.py:23-29)
    and 200 padding rows whose density and pressure hold 123 and 45, as a
    state carried in from elsewhere may."""
    half = (4.0, 4.0, 4.0)
    spawn = JS.spawn_standard(512, h=0.28, box_half=half, seed=0)
    st = JS.state_from_spawn(spawn, pad_to=spawn.count + 200)
    pad = np.nonzero(np.asarray(st.valid) == 0)[0]
    st = st.replace(density=st.density.at[pad].set(123.0),
                    pressure=st.pressure.at[pad].set(45.0))
    params = JP.FluidParams.default(
        h=0.28, box_half=np.asarray(half, np.float32)).derive_mass()
    return st, params, JP.compute_grid_dims(0, half, (0, 0, 0), 0.28)


@pytest.mark.parametrize("impl,jax_impl,want", [
    # the oracle and the all-pairs engine floor a padding row's density
    # through common.finish_density, as their JAX counterparts do
    ("brute", "brute", None),
    ("brute_kernel", "brute_pallas", None),
    # the cell engine ports pallas_sweeps, whose reassembly gives a padding
    # row rho = 0 and P = 0 (pallas_sweeps.py:1350-1352).  The JAX pallas
    # engine takes about 5 minutes in interpret mode on a CPU for one
    # substep of this state (it gave 0 and 0, run once), so the rule is
    # held as written.  sph_tpu's binned keeps the old values and its cell
    # engine floors them: the JAX package's engines differ (ROADMAP R11).
    ("cell", None, (0.0, 0.0)),
])
def test_padding_rows_follow_the_jax_counterpart(impl, jax_impl, want):
    """A padding row's density and pressure after one substep are those
    that the engine's JAX counterpart gives it (ROADMAP F4); padding rows
    are never drawn by the frame export (tests/test_torch_viz.py)."""
    state, params, dims = padded_state()
    ts = state_from_numpy(to_numpy(state), device="cpu")
    tp = params_from_numpy(to_numpy(params), device="cpu")
    cfg = SimConfig(n=ts.n, grid_dims=dims, neighbor_impl=impl)
    out, _ = TSTEP.run_substeps(
        ts, tp, TSTEP.SceneBuffers.create(cfg, device="cpu"), tp.dt, 1, cfg)
    got = {f: getattr(out, f).numpy() for f in ("density", "pressure",
                                                "valid", "orig_id")}
    pad = got["valid"] == 0
    assert pad.sum() == 200
    if want is None:
        ref = jax_run(state, params, dims, jax_impl, 1)
        ia = np.argsort(ref["orig_id"])
        ib = np.argsort(got["orig_id"])
        for f in ("density", "pressure"):
            np.testing.assert_array_equal(got[f][ib][ref["valid"][ia] == 0],
                                          ref[f][ia][ref["valid"][ia] == 0],
                                          err_msg=f)
        want = (500.0, 0.0)
    assert np.all(got["density"][pad] == want[0])
    assert np.all(got["pressure"][pad] == want[1])


def test_default_131k_builds_bit_identical():
    ts, tp, tcfg = TCFG.build("default_131k", device="cpu")
    js, jp, jcfg = JCFG.build(JCFG.CONFIGS["default_131k"])
    assert int(ts.fluid_mask().sum()) == 131072
    assert tcfg.neighbor_impl == "cell" and jcfg.neighbor_impl == "pallas"
    assert tcfg.grid_dims == jcfg.grid_dims == (72, 72, 72)
    assert tcfg.n == jcfg.n
    for k, want in to_numpy(js).items():
        np.testing.assert_array_equal(getattr(ts, k).numpy(), want,
                                      err_msg=k)
    for k, want in to_numpy(jp).items():
        np.testing.assert_allclose(np.asarray(getattr(tp, k)), want,
                                   rtol=1e-6, err_msg=k)


def test_ghost_1m_builds_bit_identical():
    ts, tp, tcfg = TCFG.build("ghost_1m", device="cpu")
    js, jp, jcfg = JCFG.build(JCFG.CONFIGS["ghost_1m"])
    assert int(ts.fluid_mask().sum()) == jcfg.n_fluid == 1_000_000
    assert int(((ts.ghost > 0) & (ts.valid > 0)).sum()) == 147_894
    assert tcfg.n == jcfg.n == 1_147_904
    assert tcfg.grid_dims == jcfg.grid_dims == (136, 136, 136)
    assert tcfg.neighbor_impl == "cell"
    for k, want in to_numpy(js).items():
        np.testing.assert_array_equal(getattr(ts, k).numpy(), want,
                                      err_msg=k)
    for k, want in to_numpy(jp).items():
        np.testing.assert_allclose(np.asarray(getattr(tp, k)), want,
                                   rtol=1e-6, err_msg=k)


def test_rotated_512k_builds_bit_identical():
    ts, tp, tcfg = TCFG.build("rotated_512k", device="cpu")
    js, jp, jcfg = JCFG.build(JCFG.CONFIGS["rotated_512k"])
    assert int(ts.fluid_mask().sum()) == jcfg.n_fluid == 524_288
    assert tcfg.n == jcfg.n
    assert tcfg.grid_dims == jcfg.grid_dims == (112, 112, 112)
    assert tcfg.neighbor_impl == "cell"
    assert tcfg.emit_rows == jcfg.emit_rows is False
    for k, want in to_numpy(js).items():
        np.testing.assert_array_equal(getattr(ts, k).numpy(), want,
                                      err_msg=k)
    for k, want in to_numpy(jp).items():
        np.testing.assert_allclose(np.asarray(getattr(tp, k)), want,
                                   rtol=1e-6, err_msg=k)


def test_export_4m_builds_bit_identical():
    ts, tp, tcfg = TCFG.build("export_4m", device="cpu")
    js, jp, jcfg = JCFG.build(JCFG.CONFIGS["export_4m"])
    assert int(ts.fluid_mask().sum()) == jcfg.n_fluid == 4_000_000
    assert tcfg.n == jcfg.n
    assert tcfg.grid_dims == jcfg.grid_dims == (208, 208, 208)
    assert tcfg.neighbor_impl == "cell"
    assert tcfg.emit_rows == jcfg.emit_rows is False
    for k, want in to_numpy(js).items():
        np.testing.assert_array_equal(getattr(ts, k).numpy(), want,
                                      err_msg=k)
    for k, want in to_numpy(jp).items():
        np.testing.assert_allclose(np.asarray(getattr(tp, k)), want,
                                   rtol=1e-6, err_msg=k)


def test_configs_kept_as_data_and_unported_parts_raise():
    """Every configuration is the JAX package's, field by field, and all
    five build (export_4m: test_export_4m_builds_bit_identical); an engine
    that is not ported raises before anything is spawned."""
    assert set(TCFG.CONFIGS) == set(JCFG.CONFIGS)
    for name, cfg in TCFG.CONFIGS.items():
        j = JCFG.CONFIGS[name]
        for f in dataclasses.fields(cfg):
            assert getattr(cfg, f.name) == getattr(j, f.name), (name, f.name)
    for name in TCFG.CONFIGS:
        with pytest.raises(NotImplementedError, match="binned"):
            TCFG.build(name, neighbor_impl="binned", device="cpu")
    # dam_break_8k builds with the all-pairs kernels, or with the oracle
    for impl, want in ((None, "brute_kernel"), ("brute", "brute")):
        state, _, cfg = TCFG.build("dam_break_8k", neighbor_impl=impl,
                                   device="cpu")
        assert cfg.neighbor_impl == want and int(state.valid.sum()) == 8192


def test_engine_dispatch_and_frame_accumulator():
    ts, tp, cfg = TCFG.build(TCFG.BenchConfig(
        name="tiny", n_target=300, box_half=(2.0, 2.0, 2.0)), device="cpu")
    buffers = TSTEP.SceneBuffers.create(cfg, device="cpu")
    with pytest.raises(ValueError, match="neighbor_impl"):
        TSTEP.run_substeps(ts, tp, buffers, tp.dt, 1,
                           dataclasses.replace(cfg, neighbor_impl="pallas"))
    # river mode runs: the zero heightfield, whose footprint covers the box,
    # lifts the fluid of the box's lower half to y = 0.001, and no row is
    # below the sink or past it
    river = dataclasses.replace(cfg, river_mode=True)
    out, buf = TSTEP.substep(ts, tp, buffers, tp.dt, river)
    y = out.pos[out.fluid_mask()][:, 1]
    assert bool((ts.pos[ts.fluid_mask()][:, 1] < 0).any())
    assert bool((y >= 0).all()) and bool((y == 0.001).any())
    assert int(buf.recycled) == 0 and int(buf.fountain_seed) == 0
    for args in ((1 / 60, 1e-3, 16, 0.0), (1 / 30, 4e-3, 16, 0.002),
                 (0.0, 1e-3, 16, 0.0025)):
        assert (TSTEP.substeps_for_frame(*args)
                == JSTEP.substeps_for_frame(*args))


def test_port_imports_no_jax():
    """Importing the port's entry points must not import JAX, flax, PIL
    (absent from the card's machine) or the JAX package; the frame export's
    modules, the host rasterizer's build and the scene's modules
    included."""
    code = (
        "import sys\n"
        "BLOCKED = ('jax', 'jaxlib', 'flax', 'PIL')\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCKED:\n"
        "            raise ImportError('blocked: ' + name)\n"
        "for m in [m for m in sys.modules if m.split('.')[0] in BLOCKED]:\n"
        "    del sys.modules[m]\n"
        "sys.meta_path.insert(0, Block())\n"
        "import sph_tpu_torch.engine.step, sph_tpu_torch.app.configs\n"
        "import sph_tpu_torch.native.build\n"
        "import sph_tpu_torch.physics.brute_kernels\n"
        "import sph_tpu_torch.physics.impulses\n"
        "import sph_tpu_torch.app.microbench, sph_tpu_torch.app.proto_expand\n"
        "import sph_tpu_torch.app.bench, sph_tpu_torch.viz.camera\n"
        "import sph_tpu_torch.viz.palettes, sph_tpu_torch.viz.splat\n"
        "import sph_tpu_torch.physics.emitters, sph_tpu_torch.core.convert\n"
        "import sph_tpu_torch.io.presets, sph_tpu_torch.scene.settings\n"
        "import sph_tpu_torch.scene.art_presets, sph_tpu_torch.scene.river\n"
        "import sph_tpu_torch.scene.reaction, sph_tpu_torch.scene.scene\n"
        "sph_tpu_torch.native.build.splat_library()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       BLOCKED + ('sph_tpu',)]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
