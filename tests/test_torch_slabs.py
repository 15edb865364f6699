"""The slab engine (sph_tpu_torch.parallel.slabs) against ``sph_tpu``'s:
the port's ranks run as four gloo processes (``parallel.group.launch`` of
``parallel/run.py``, one launch for every case of this file, a file
rendezvous in a tmp dir), the JAX side in this process on conftest's
virtual 8-device mesh.  Every case starts from the same numpy inputs,
spawned by the JAX package:

- the 2,048-row fixture of ``tests/test_slabs.py:20-27`` over 4 slabs,
  5 substeps, against JAX ``slabs.make_slab_substep`` on a 4-device mesh
  and JAX ``binned`` on one device (pos 1e-4, vel 1e-3, density 1.0,
  ``tests/test_brute_pallas.py:40-42``), rows conserved;
- migration over 10 substeps (1,024 rows, half 5): rows conserved, within
  those tolerances of the port's one-device cell engine;
- ``shard_by_slab`` putting each row on the slab that JAX's puts it on;
- one rank, bit-identical to ``engine.step.run_substeps``;
- the ghost shell of ``chip_smoke.ghost_shell_fixture`` (512 rows) and a
  rotated box over 4 slabs against one device;
- the router in fountain mode (the JAX dry run's stage 2: 384 rows, half
  3.2, 2 substeps, against JAX ``binned`` within 1e-4) and in river mode
  (stage 3: 256 rows, the sink forced toward the emitter's slab): rows
  conserved, the respawns counted as on one device, within the tolerances
  of the port's one-device cell engine after 2 substeps and of JAX
  ``brute`` after 1 (ROADMAP R12).

CUDA (marker ``cuda``, skipped without a card): one NCCL rank on the card,
bit-identical to the cell engine's kernels on one device, from inputs the
port spawns itself:

    python -m pytest tests/test_torch_slabs.py -q -m cuda --noconftest
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from sph_tpu_torch.core import convert
from sph_tpu_torch.core import params as TP
from sph_tpu_torch.engine import step as TSTEP
from sph_tpu_torch.parallel import group as G, run as R, slabs

WORLD = 4
POS_TOL, VEL_TOL, RHO_TOL = 1e-4, 1e-3, 1.0   # test_brute_pallas.py:40-42
ROUTER_TOL = 1e-4                             # parallel/dryrun.py:665


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU ops on one thread while this module runs: the suite
    runs in several processes at once, where each process's pool of torch
    threads spins against the others'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_numpy(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def by_id(d):
    """A state's valid rows ordered by orig_id: {field: array}."""
    v = np.asarray(d["valid"]) > 0
    o = np.argsort(np.asarray(d["orig_id"])[v], kind="stable")
    return {k: np.asarray(d[k])[v][o]
            for k in ("pos", "vel", "density", "orig_id", "ghost")}


def assert_close(got, want, pos=POS_TOL, vel=VEL_TOL, rho=RHO_TOL):
    g, w = by_id(got), by_id(want)
    np.testing.assert_array_equal(g["orig_id"], w["orig_id"])
    assert not np.isnan(g["pos"]).any()
    for f, tol in (("pos", pos), ("vel", vel), ("density", rho)):
        err = float(np.abs(g[f] - w[f]).max())
        assert err < tol, f"{f}: {err} >= {tol}"


# ---------------------------------------------------------------------------
# the cases, spawned by the JAX package
# ---------------------------------------------------------------------------

def jax_case(n, half, seed=0, shell=False, euler=(0.0, 0.0, 0.0), **modes):
    """(state, params, buffers, JAX SimConfig) of the JAX package."""
    import jax.numpy as jnp
    from sph_tpu.core import params as JP
    from sph_tpu.core import state as JS
    from sph_tpu.engine import step as JSTEP

    spawn = JS.spawn_standard(n, h=0.28, box_half=half, seed=seed,
                              box_euler_deg=euler,
                              spawn_rotation="local" if any(euler)
                              else "ignore")
    if shell:   # chip_smoke.ghost_shell_fixture
        spawn.pos += np.asarray([-0.35, -0.2, -0.35], np.float32)
        spawn = JS.concat_spawns(
            spawn, JS.spawn_ghost_box_shell(h=0.28, box_half=half))
    state = JS.state_from_spawn(spawn)
    params = JP.FluidParams.default(
        box_half=np.asarray(half, np.float32),
        box_euler_deg=np.asarray(euler, np.float32)).derive_mass()
    dims = JP.compute_grid_dims(0, half, euler, 0.28)
    cfg = JP.SimConfig(n=state.n, grid_dims=dims, neighbor_impl="binned",
                       **modes)
    buffers = JSTEP.SceneBuffers.create(cfg)
    if modes.get("river_mode"):
        from sph_tpu.scene import river as JR
        spec = JR.RiverSpec.random(3)
        terrain = JR.generate_river_terrain(spec, (0.0, 0.0, 0.0), half,
                                            res=cfg.terrain_res)
        params = JR.river_params(params, spec, (0.0, 0.0, 0.0), half)
        # the sink forced toward the emitter's slab (dryrun.py:696-700)
        params = params.replace(
            river_sink_z_max=jnp.float32(0.0),
            river_emitter_pos=jnp.asarray([0.0, 1.0, -2.8], jnp.float32),
            river_sink_y=jnp.float32(-20.0))
        buffers = buffers.replace(terrain=jnp.asarray(terrain))
    return state, params, buffers, cfg


def port_config(jcfg):
    return TP.SimConfig(n=jcfg.n, grid_dims=tuple(jcfg.grid_dims),
                        neighbor_impl="cell", river_mode=jcfg.river_mode,
                        fountain_mode=jcfg.fountain_mode,
                        terrain_res=tuple(jcfg.terrain_res))


# name -> (jax_case kwargs, checkpoints, ranks)
CASES = {
    "slab": (dict(n=2048, half=(6.0, 6.0, 6.0)), [5], WORLD),
    "one_rank": (dict(n=2048, half=(6.0, 6.0, 6.0)), [5], 1),
    "migration": (dict(n=1024, half=(5.0, 5.0, 5.0)), [0, 10], WORLD),
    "ghost_shell": (dict(n=512, half=(3.0, 3.0, 3.0), seed=1, shell=True),
                    [5], WORLD),
    "rotated": (dict(n=1024, half=(4.0, 4.0, 4.0), seed=4,
                     euler=(20.0, 0.0, 30.0)), [5], WORLD),
    "fountain": (dict(n=384, half=(3.2, 3.2, 3.2), seed=2,
                      fountain_mode=True), [2], WORLD),
    "river": (dict(n=256, half=(3.2, 3.2, 3.2), seed=3, river_mode=True),
              [1, 2], WORLD),
}


@pytest.fixture(scope="module")
def inputs():
    """name -> (JAX state, params, buffers, config): the JAX objects."""
    return {name: jax_case(**kw) for name, (kw, _, _) in CASES.items()}


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """One launch of WORLD gloo ranks running every case; returns the
    directory they wrote to."""
    out = str(tmp_path_factory.mktemp("slab_ranks"))
    jobs = []
    for name, (_, checkpoints, n_ranks) in CASES.items():
        state, params, buffers, jcfg = inputs[name]
        path = R.save_input(os.path.join(out, f"{name}.in.npz"),
                            to_numpy(state), to_numpy(params),
                            to_numpy(buffers))
        jobs.append({"name": name, "engine": "slab", "input": path,
                     "config": dataclasses.asdict(port_config(jcfg)),
                     "checkpoints": checkpoints, "ranks": n_ranks})
    with open(os.path.join(out, "jobs.json"), "w") as f:
        json.dump(jobs, f)
    G.check(G.launch("sph_tpu_torch.parallel.run", WORLD,
                     [os.path.join(out, "jobs.json")], out, backend="gloo",
                     device="cpu", timeout=300))
    return out


def got(ranks, name, k):
    return R.read_state(os.path.join(ranks, f"{name}_{k}.npz"))


def stats(ranks, name, n_ranks=WORLD):
    out = []
    for r in range(n_ranks):
        with open(os.path.join(ranks, f"{name}_rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def port_run(inputs, name, n_sub):
    """The port's one-device cell engine on the CPU: (state, buffers) as
    numpy after ``n_sub`` substeps."""
    state, params, buffers, jcfg = inputs[name]
    ts = convert.state_from_numpy(to_numpy(state), device="cpu")
    tp = convert.params_from_numpy(to_numpy(params), device="cpu")
    tb = convert.buffers_from_numpy(to_numpy(buffers), device="cpu")
    out, ob = TSTEP.run_substeps(ts, tp, tb, tp.dt, n_sub, port_config(jcfg))
    return convert.to_numpy(out), int(ob.recycled)


def jax_run(inputs, name, n_sub, impl="binned"):
    from sph_tpu.engine import step as JSTEP
    state, params, buffers, jcfg = inputs[name]
    cfg = dataclasses.replace(jcfg, neighbor_impl=impl)
    out, _ = JSTEP.run_substeps(state, params, buffers, params.dt, n_sub, cfg)
    return to_numpy(out)


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

def test_slab_engine_matches_jax_slabs_and_binned(inputs, ranks):
    import jax
    from sph_tpu.parallel import slabs as JSL
    state, params, _, jcfg = inputs["slab"]
    mesh = JSL.make_mesh_slabs(WORLD)
    scfg = JSL.make_slab_config(jcfg, WORLD, state.n)
    st = JSL.shard_by_slab(state, params, scfg, mesh)
    jstep = JSL.make_slab_substep(mesh, scfg)
    for _ in range(5):
        st = jstep(st, params, params.dt)
    mine = got(ranks, "slab", 5)
    assert_close(mine, to_numpy(jax.device_get(st)))
    assert_close(mine, jax_run(inputs, "slab", 5))
    assert sum(s["rows"][-1] for s in stats(ranks, "slab")) == int(
        np.asarray(state.valid).sum())


def test_migration_conserves_rows(inputs, ranks):
    state = inputs["migration"][0]
    n0 = int(np.asarray(state.valid).sum())
    st = stats(ranks, "migration")
    assert sum(s["rows"][0] for s in st) == n0
    assert sum(s["rows"][1] for s in st) == n0
    # rows crossed slab edges in the 10 substeps
    assert any(s["rows"][0] != s["rows"][1] for s in st)
    want, _ = port_run(inputs, "migration", 10)
    assert_close(got(ranks, "migration", 10), want)


def test_shard_by_slab_matches_jax(inputs):
    from sph_tpu.parallel import slabs as JSL
    state, params, buffers, jcfg = inputs["slab"]
    mesh = JSL.make_mesh_slabs(WORLD)
    jscfg = JSL.make_slab_config(jcfg, WORLD, state.n)
    jst = to_numpy(JSL.shard_by_slab(state, params, jscfg, mesh))
    scfg = slabs.make_slab_config(port_config(jcfg), WORLD)
    assert scfg.dims == tuple(jscfg.dims)
    ids = []
    for r in range(WORLD):
        sl = slice(r * jscfg.n_shard, (r + 1) * jscfg.n_shard)
        want = jst["orig_id"][sl][jst["valid"][sl] > 0]
        mine, _, _ = convert.shard_from_numpy(
            to_numpy(state), to_numpy(params), to_numpy(buffers), r, WORLD,
            scfg, device="cpu")
        np.testing.assert_array_equal(mine.orig_id.numpy(), want)
        ids.append(want)
    assert len(np.concatenate(ids)) == int(np.asarray(state.valid).sum())


def test_one_rank_bit_identical_to_run_substeps(inputs, ranks):
    want, _ = port_run(inputs, "one_rank", 5)
    mine = got(ranks, "one_rank", 5)
    w = {k: v[np.asarray(want["valid"]) > 0] for k, v in want.items()}
    o = np.argsort(w["orig_id"], kind="stable")
    for f in ("pos", "vel", "acc", "density", "pressure", "foam", "ghost",
              "face", "orig_id"):
        np.testing.assert_array_equal(mine[f], w[f][o], err_msg=f)


def test_ghost_shell_over_four_slabs(inputs, ranks):
    want, _ = port_run(inputs, "ghost_shell", 5)
    mine = got(ranks, "ghost_shell", 5)
    assert_close(mine, want)
    g, w = by_id(mine), by_id(want)
    ghost = w["ghost"] > 0
    assert ghost.sum() > 0
    np.testing.assert_array_equal(g["pos"][ghost], w["pos"][ghost])
    # the ghosts stand on all four slabs
    assert all(s["rows"][-1] > 0 for s in stats(ranks, "ghost_shell"))


def test_rotated_box_over_four_slabs(inputs, ranks):
    want, _ = port_run(inputs, "rotated", 5)
    assert_close(got(ranks, "rotated", 5), want)
    assert_close(got(ranks, "rotated", 5), jax_run(inputs, "rotated", 5))


def test_router_fountain_matches_jax_binned(inputs, ranks):
    mine = got(ranks, "fountain", 2)
    assert_close(mine, jax_run(inputs, "fountain", 2), pos=ROUTER_TOL)
    want, recycled = port_run(inputs, "fountain", 2)
    assert_close(mine, want, pos=ROUTER_TOL)
    assert mine["recycled"] == recycled


def test_router_river_routes_across_slabs(inputs, ranks):
    for k in (1, 2):
        mine = got(ranks, "river", k)
        want, recycled = port_run(inputs, "river", k)
        assert_close(mine, want)
        assert mine["recycled"] == recycled
    assert recycled > 0
    assert_close(got(ranks, "river", 1), jax_run(inputs, "river", 1, "brute"))


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_one_nccl_rank_on_card_bit_identical(cuda, tmp_path):
    from sph_tpu_torch.parallel import dryrun
    state, params, config, buffers = dryrun._case(
        4096, (6.0, 6.0, 6.0), 0, cuda, neighbor_impl="cell")
    path = R.save_input(str(tmp_path / "in.npz"), convert.to_numpy(state),
                        convert.to_numpy(params), convert.to_numpy(buffers))
    with open(tmp_path / "jobs.json", "w") as f:
        json.dump([{"name": "one", "engine": "slab", "input": path,
                    "config": dataclasses.asdict(config),
                    "checkpoints": [8]}], f)
    G.check(G.launch("sph_tpu_torch.parallel.run", 1,
                     [str(tmp_path / "jobs.json")], str(tmp_path),
                     backend="nccl", device="cuda"))
    want, _ = TSTEP.run_substeps(state, params, buffers, params.dt, 8,
                                 config)
    w = by_id(convert.to_numpy(want))
    g = by_id(R.read_state(str(tmp_path / "one_8.npz")))
    for f in ("pos", "vel", "density", "orig_id"):
        np.testing.assert_array_equal(g[f], w[f], err_msg=f)
    (rank,) = stats(str(tmp_path), "one", 1)
    assert rank["launches"]["density"] == 8
    assert rank["launches"]["force_xsph"] == 8
