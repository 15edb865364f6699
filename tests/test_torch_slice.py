"""The port's main path as a whole: ``engine.step.run_substeps`` with the
``"cell"`` engine against ``sph_tpu`` (``"brute"`` and ``"cell"``), the
bench configurations, and the guards (no JAX import, ghosts raise)."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from sph_tpu.app import configs as JCFG
from sph_tpu.core import params as JP
from sph_tpu.core import state as JS
from sph_tpu.engine import step as JSTEP
from sph_tpu_torch.app import configs as TCFG
from sph_tpu_torch.core.convert import params_from_numpy, state_from_numpy
from sph_tpu_torch.core.params import SimConfig
from sph_tpu_torch.engine import step as TSTEP

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
    ts = state_from_numpy(to_numpy(state))
    tp = params_from_numpy(to_numpy(params))
    out = TSTEP.run_substeps(ts, tp, tp.dt, n_sub,
                             SimConfig(n=ts.n, grid_dims=dims))
    return {f.name: getattr(out, f.name).numpy()
            for f in dataclasses.fields(out)}


def realigned_errors(ref, got):
    """Max abs differences over valid rows, after aligning by orig_id."""
    ia = np.argsort(ref["orig_id"], kind="stable")
    ib = np.argsort(got["orig_id"], kind="stable")
    v = ref["valid"][ia] > 0
    assert np.array_equal(got["valid"][ib] > 0, v)
    return {f: float(np.abs(ref[f][ia][v] - got[f][ib][v]).max())
            for f in ("pos", "vel", "density")}


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


@pytest.fixture(scope="module")
def runs(dam_break_small):
    state, params, dims = dam_break_small
    crowd = crowded_state()
    return {
        "jax_brute": jax_run(state, params, dims, "brute", N_SUB),
        "jax_cell": jax_run(state, params, dims, "cell", N_SUB),
        "port_cell": port_run(state, params, dims, N_SUB),
        "crowd_jax_brute": jax_run(*crowd, "brute", N_SUB),
        "crowd_port_cell": port_run(*crowd, N_SUB),
    }


@pytest.mark.parametrize("ref,got", [
    ("jax_brute", "port_cell"),
    ("jax_cell", "port_cell"),
    ("crowd_jax_brute", "crowd_port_cell"),
])
def test_cell_engine_matches_reference(runs, ref, got):
    err = realigned_errors(runs[ref], runs[got])
    assert err["pos"] < POS_TOL, err
    assert err["vel"] < VEL_TOL, err
    assert err["density"] < RHO_TOL, err


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


def test_default_131k_builds_bit_identical():
    ts, tp, tcfg = TCFG.build("default_131k")
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


def test_configs_kept_as_data_and_unported_parts_raise():
    assert set(TCFG.CONFIGS) == set(JCFG.CONFIGS)
    for name, cfg in TCFG.CONFIGS.items():
        j = JCFG.CONFIGS[name]
        for f in dataclasses.fields(cfg):
            assert getattr(cfg, f.name) == getattr(j, f.name), (name, f.name)
    for name in ("dam_break_8k", "rotated_512k", "ghost_1m", "export_4m"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TCFG.build(name)
    # the all-pairs oracle builds dam_break_8k's physics today
    state, _, cfg = TCFG.build("dam_break_8k", neighbor_impl="brute")
    assert cfg.neighbor_impl == "brute" and int(state.valid.sum()) == 8192


def test_engine_dispatch_and_frame_accumulator():
    ts, tp, cfg = TCFG.build(TCFG.BenchConfig(
        name="tiny", n_target=300, box_half=(2.0, 2.0, 2.0)))
    with pytest.raises(ValueError, match="neighbor_impl"):
        TSTEP.run_substeps(ts, tp, tp.dt, 1,
                           dataclasses.replace(cfg, neighbor_impl="pallas"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TSTEP.substep(ts, tp, tp.dt,
                      dataclasses.replace(cfg, river_mode=True))
    for args in ((1 / 60, 1e-3, 16, 0.0), (1 / 30, 4e-3, 16, 0.002),
                 (0.0, 1e-3, 16, 0.0025)):
        assert (TSTEP.substeps_for_frame(*args)
                == JSTEP.substeps_for_frame(*args))


def test_port_imports_no_jax():
    """Importing the port's entry points must not import JAX or flax."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "for m in [m for m in sys.modules if m.split('.')[0] in\n"
        "          ('jax', 'jaxlib', 'flax')]:\n"
        "    del sys.modules[m]\n"
        "sys.meta_path.insert(0, Block())\n"
        "import sph_tpu_torch.engine.step, sph_tpu_torch.app.configs\n"
        "import sph_tpu_torch.native.build\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'sph_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
