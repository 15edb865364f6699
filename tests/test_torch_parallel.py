"""The gather-parallel engine (sph_tpu_torch.parallel.domain), the ranks'
transport and launcher (``parallel/group.py``), the dry run and the
conversions of a global run to a rank's part and back (``core/convert.py``),
against ``sph_tpu``.  The port's ranks run as four gloo processes (one
launch for the file, a file rendezvous in a tmp dir), the JAX side in this
process on conftest's virtual 8-device mesh:

- the gather engine on 4 ranks against JAX ``domain.make_sharded_substep``
  on a 4-device mesh and JAX ``brute`` on one device: 512 rows, fountain
  on, 5 substeps, pos < 1e-5, density < 0.1 (``tests/test_parallel.py``);
- ``python -m sph_tpu_torch.parallel.dryrun 4 --device cpu --backend gloo``
  exiting 0;
- a JAX state to each rank's part (by slab, by block of rows) and back
  through ``gather_global``, exactly;
- the cell table's key hook (a slab's grid), the halo rows' source
  records, the launcher's failures and NCCL's refusals.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sph_tpu_torch.core import convert
from sph_tpu_torch.core import params as TP
from sph_tpu_torch.core import state as TS
from sph_tpu_torch.neighbors import cells, sweeps
from sph_tpu_torch.parallel import group as G, run as R, slabs

WORLD = 4
GATHER_POS_TOL, GATHER_RHO_TOL = 1e-5, 0.1   # tests/test_parallel.py:33-36
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def port_config(jcfg, impl):
    return TP.SimConfig(n=jcfg.n, grid_dims=tuple(jcfg.grid_dims),
                        neighbor_impl=impl, fountain_mode=jcfg.fountain_mode)


@pytest.fixture(scope="module")
def gather_case():
    """tests/test_parallel.py's 512 rows (pad 512), fountain on, as the
    JAX package builds them: (state, params, buffers, JAX SimConfig)."""
    from sph_tpu.core import params as JP
    from sph_tpu.core import state as JS
    from sph_tpu.engine import step as JSTEP
    state = JS.state_from_spawn(JS.spawn_standard(512, seed=3), pad_to=512)
    params = JP.FluidParams.default().derive_mass()
    dims = JP.compute_grid_dims(0, np.array([7.0, 7.0, 7.0]),
                                np.array([0.0, 0.0, 0.0]), 0.28)
    cfg = JP.SimConfig(n=512, grid_dims=dims, neighbor_impl="brute",
                       fountain_mode=True)
    return state, params, JSTEP.SceneBuffers.create(cfg), cfg


@pytest.fixture(scope="module")
def shell_case():
    """A ghost shell around 512 fluid rows (every field in use), as the
    JAX package builds it."""
    from sph_tpu.core import params as JP
    from sph_tpu.core import state as JS
    from sph_tpu.engine import step as JSTEP
    half = (3.0, 3.0, 3.0)
    spawn = JS.concat_spawns(JS.spawn_standard(512, box_half=half, seed=1,
                                               mix_pattern=2),
                             JS.spawn_ghost_box_shell(h=0.28, box_half=half))
    state = JS.state_from_spawn(spawn)
    params = JP.FluidParams.default(
        box_half=np.asarray(half, np.float32)).derive_mass()
    dims = JP.compute_grid_dims(0, half, (0, 0, 0), 0.28)
    cfg = JP.SimConfig(n=state.n, grid_dims=dims)
    return state, params, JSTEP.SceneBuffers.create(cfg), cfg


@pytest.fixture(scope="module")
def ranks(gather_case, shell_case, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("gather_ranks"))
    jobs = []
    for name, engine, case, ckpt in (
            ("gather", "gather", gather_case, [5]),
            ("back_slab", "slab", shell_case, [0]),
            ("back_rows", "gather", gather_case, [0])):
        state, params, buffers, jcfg = case
        path = R.save_input(os.path.join(out, f"{name}.in.npz"),
                            to_numpy(state), to_numpy(params),
                            to_numpy(buffers))
        impl = "brute" if engine == "gather" else "cell"
        jobs.append({"name": name, "engine": engine, "input": path,
                     "config": dataclasses.asdict(port_config(jcfg, impl)),
                     "checkpoints": ckpt})
    with open(os.path.join(out, "jobs.json"), "w") as f:
        json.dump(jobs, f)
    res = G.check(G.launch("sph_tpu_torch.parallel.run", WORLD,
                           [os.path.join(out, "jobs.json")], out,
                           backend="gloo", device="cpu", timeout=300))
    # the launcher names what the ranks wrote: rank 0's checkpoints and
    # each rank's stats of each job
    assert [os.path.basename(f) for f in res.files] == sorted(
        [f"{n}_{k}.npz" for n, k in (("gather", 5), ("back_slab", 0),
                                     ("back_rows", 0))]
        + [f"{n}_rank{r}.json" for n in ("gather", "back_slab", "back_rows")
           for r in range(WORLD)])
    return out


# ---------------------------------------------------------------------------
# the gather engine
# ---------------------------------------------------------------------------

def test_gather_engine_matches_jax_domain_and_brute(gather_case, ranks):
    import jax
    from sph_tpu.engine import step as JSTEP
    from sph_tpu.parallel import domain as JD
    state, params, buffers, cfg = gather_case
    ref, _ = JSTEP.run_substeps(state, params, buffers, params.dt, 5, cfg)
    mesh = JD.make_mesh(WORLD)
    jstep = JD.make_sharded_substep(mesh, cfg)
    st, b = JD.shard_state(state, mesh), buffers
    for _ in range(5):
        st, b = jstep(st, params, b, params.dt)
    mine = R.read_state(os.path.join(ranks, "gather_5.npz"))
    v = np.asarray(state.valid) > 0
    # the gather engine keeps every row in place
    np.testing.assert_array_equal(mine["orig_id"], np.arange(512))
    for want in (to_numpy(ref), to_numpy(jax.device_get(st))):
        dpos = np.abs(mine["pos"] - want["pos"])[v].max()
        drho = np.abs(mine["density"] - want["density"])[v].max()
        assert dpos < GATHER_POS_TOL, dpos
        assert drho < GATHER_RHO_TOL, drho


def test_dryrun_on_four_cpu_ranks(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-m", "sph_tpu_torch.parallel.dryrun", "4",
         "--device", "cpu", "--backend", "gloo", "--out", str(tmp_path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    line = res.stdout.strip().splitlines()[-1]
    assert line.startswith("dryrun(4, cpu, gloo): ok"), line


# ---------------------------------------------------------------------------
# a global run to a rank's part and back
# ---------------------------------------------------------------------------

def _valid(d):
    v = np.asarray(d["valid"]) > 0
    o = np.argsort(np.asarray(d["orig_id"])[v], kind="stable")
    return {k: np.asarray(x)[v][o] for k, x in d.items()}


@pytest.mark.parametrize("by", ["slab", "rows"])
def test_shard_from_numpy_splits_the_state(shell_case, gather_case, by):
    state, params, buffers, jcfg = shell_case if by == "slab" else gather_case
    scfg = (slabs.make_slab_config(port_config(jcfg, "cell"), WORLD)
            if by == "slab" else None)
    parts = [convert.shard_from_numpy(to_numpy(state), to_numpy(params),
                                      to_numpy(buffers), r, WORLD, scfg,
                                      device="cpu")
             for r in range(WORLD)]
    whole = convert.to_numpy(slabs.concat(
        slabs.concat(parts[0][0], parts[1][0]),
        slabs.concat(parts[2][0], parts[3][0])))
    want = to_numpy(state)
    if by == "slab":
        whole, want = _valid(whole), _valid(want)
        assert all(p[0].n > 0 for p in parts)
    for f, v in want.items():
        np.testing.assert_array_equal(whole[f], v, err_msg=f)
    for p in parts:      # params and buffers whole on every rank
        np.testing.assert_array_equal(p[1].box_half.numpy(),
                                      np.asarray(params.box_half))
        assert p[1].shape_type == int(params.shape_type)


@pytest.mark.parametrize("name", ["back_slab", "back_rows"])
def test_gathered_to_numpy_returns_the_state(shell_case, gather_case, ranks,
                                             name):
    state = (shell_case if name == "back_slab" else gather_case)[0]
    mine = R.read_state(os.path.join(ranks, f"{name}_0.npz"))
    want = to_numpy(state)
    if name == "back_slab":
        want = _valid(want)
    for f, v in want.items():
        np.testing.assert_array_equal(mine[f], v.astype(mine[f].dtype),
                                      err_msg=f)


def test_pack_rows_round_trip(shell_case):
    st = convert.state_from_numpy(to_numpy(shell_case[0]), device="cpu")
    back = slabs.unpack_rows(slabs.pack_rows(st))
    for f in dataclasses.fields(st):
        a, b = getattr(st, f.name), getattr(back, f.name)
        assert a.dtype == b.dtype and torch.equal(a, b), f.name
    assert slabs.pack_rows(slabs.take(st, torch.arange(0))).shape == (0, 18)


def test_compact_is_nonzero():
    g = torch.Generator().manual_seed(0)
    keep = torch.rand(1000, generator=g) < 0.3
    want = torch.nonzero(keep).squeeze(1)
    assert torch.equal(slabs._compact(keep, want.numel()), want)


# ---------------------------------------------------------------------------
# the cell engine's hook
# ---------------------------------------------------------------------------

def test_cell_table_takes_the_callers_keys(shell_case):
    state, params, _, jcfg = shell_case
    ts = convert.state_from_numpy(to_numpy(state), device="cpu")
    tp = convert.params_from_numpy(to_numpy(params), device="cpu")
    dims = tuple(jcfg.grid_dims)
    own = cells.build(ts, tp, dims)
    key = cells.compute_keys_ymajor(ts.pos, ts.fluid_mask(), tp, dims)
    given = cells.build(ts, tp, dims, key)
    for a, b in zip(own, given):
        if isinstance(a, TS.ParticleState):
            for f in dataclasses.fields(a):
                assert torch.equal(getattr(a, f.name), getattr(b, f.name))
        else:
            assert torch.equal(a, b)
    assert torch.equal(ts.orig_id[own.order], own.state.orig_id)
    gown = cells.build_ghosts(ts, tp, dims)
    ggiven = cells.build_ghosts(
        ts, tp, dims, cells.compute_keys_ymajor(
            ts.pos, torch.ones_like(ts.valid, dtype=bool), tp, dims))
    for a, b in zip(gown, ggiven):
        assert torch.equal(a, b)


def test_slab_keys_put_the_halo_on_its_planes(shell_case):
    """On a slab's grid the rank's rows lie on planes 1..nz_local and its
    neighbours' on 0 and nz_local + 1, in the global y-major order."""
    state, params, _, jcfg = shell_case
    tp = convert.params_from_numpy(to_numpy(params), device="cpu")
    scfg = slabs.make_slab_config(port_config(jcfg, "cell"), WORLD)
    pos = convert.state_from_numpy(to_numpy(state), device="cpu").pos
    c = TP.grid_cell_coords(pos, tp, scfg.dims)
    rank = 1
    c_loc, lz = slabs._local_coords(pos, tp, scfg, rank)
    mine = slabs.slab_of(pos, tp, scfg) == rank
    assert torch.equal(lz[mine] + 1, c[mine, 2] - scfg.nz_local * rank + 1)
    below = c[:, 2] == scfg.nz_local * rank - 1
    above = c[:, 2] == scfg.nz_local * (rank + 1)
    cxy = torch.cat([c[below, :2], c[above, :2]])
    halo = slabs._halo_coords(cxy, scfg, int(below.sum()))
    assert 0 < int(below.sum()) < halo.shape[0]
    assert bool((halo[:int(below.sum()), 2] == 0).all())
    assert bool((halo[int(below.sum()):, 2] == scfg.nz_local + 1).all())
    assert torch.equal(halo[:, :2], cxy)


def test_set_source_density_is_pack_sources():
    g = torch.Generator().manual_seed(1)
    n = 64
    pos, vel = torch.rand(n, 3, generator=g), torch.rand(n, 3, generator=g)
    rho = 900 + 200 * torch.rand(n, generator=g)
    pv = sweeps.SweepParams(torch.full((15,), 0.5), 4, 4, 4)
    src = sweeps.pack_sources(pos, vel, torch.zeros(n), pv)
    rows = torch.arange(0, n, 3)
    sweeps.set_source_density(src, rows, rho[rows], pv)
    want = sweeps.pack_sources(pos, vel, torch.where(
        torch.isin(torch.arange(n), rows), rho, 0.0), pv)
    assert torch.equal(src, want)


# ---------------------------------------------------------------------------
# the launcher and the backends
# ---------------------------------------------------------------------------

def test_a_failing_rank_fails_the_launch(tmp_path):
    res = G.launch("sph_tpu_torch.parallel.run", 2,
                   [str(tmp_path / "no_such_jobs.json")], str(tmp_path),
                   device="cpu", timeout=120)
    assert all(c != 0 for c in res.codes)
    with pytest.raises(RuntimeError, match="ranks failed"):
        G.check(res)


def test_nccl_refuses_what_it_cannot_run(tmp_path):
    init = f"file://{tmp_path}/rdv"
    with pytest.raises(ValueError, match="CUDA"):
        G.init(0, 1, "nccl", init, device="cpu")
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match="a card a rank"):
            G.init(0, 2, "nccl", init, device="cuda")
    with pytest.raises(ValueError, match="backend"):
        G.init(0, 1, "mpi", init, device="cpu")
