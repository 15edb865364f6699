"""The cell table and the ghost structure (sph_tpu_torch.neighbors.cells).

CPU: the plain cell table has ``torch.searchsorted``'s range semantics
(empty cells at the head, middle and tail of the grid, no rows at all),
and the sorted rows, ranges and in-cell slots agree with the JAX
package's sorts (``planes.sort_particles`` for the fluid,
the key/rank sort inside ``planes.build_ghost_tables`` for the ghosts).

CUDA (marker ``cuda``, skipped without a card): the kernel against the
plain version, bit-equal.  JAX is imported inside the tests that need it,
so the CUDA tests also run where JAX is not installed:

    python -m pytest tests/test_torch_cells.py -q -m cuda --noconftest
"""
import dataclasses

import numpy as np
import pytest
import torch

from sph_tpu_torch.core import params as TP
from sph_tpu_torch.core import state as TS
from sph_tpu_torch.neighbors import cells

NUM_CELLS = 12
# cell occupancy per fixture; every fixture adds rows outside the table
# (key NUM_CELLS) after the table rows, except "no_rows"
OCCUPANCY = {
    "empty_head": [0, 0, 0, 2, 1, 3, 1, 1, 2, 1, 1, 1],
    "empty_middle": [1, 2, 0, 0, 0, 3, 1, 0, 2, 1, 1, 1],
    "empty_tail": [2, 1, 1, 3, 0, 0, 0, 0, 0, 0, 0, 0],
    "no_table_rows": [0] * NUM_CELLS,
    "no_rows": [0] * NUM_CELLS,
}


def table_fixture(name, seed=0, device="cpu"):
    """(skey, order, pos, vel) for one occupancy fixture."""
    counts = np.asarray(OCCUPANCY[name])
    outside = 0 if name == "no_rows" else 3
    skey = np.concatenate([np.repeat(np.arange(NUM_CELLS), counts),
                           np.full(outside, NUM_CELLS)]).astype(np.int32)
    rng = np.random.default_rng(seed)
    n = skey.shape[0]
    order = rng.permutation(n).astype(np.int64)
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    vel = rng.normal(size=(n, 3)).astype(np.float32)
    return tuple(torch.as_tensor(a, device=device)
                 for a in (skey, order, pos, vel))


@pytest.mark.parametrize("name", list(OCCUPANCY))
def test_cell_table_plain_has_searchsorted_ranges(name):
    skey, order, pos, vel = table_fixture(name)
    tbl = cells.cell_table(skey, order, pos, vel, NUM_CELLS)
    counts = np.asarray(OCCUPANCY[name])
    before = np.concatenate([[0], np.cumsum(counts)[:-1]])
    # start = first row with key >= c, end = first row with key > c: an
    # empty cell sits at its insertion point, never at 0 past a full cell
    np.testing.assert_array_equal(tbl.cell_start.numpy(), before)
    np.testing.assert_array_equal(tbl.cell_end.numpy(), before + counts)
    assert tbl.cell_start.dtype == tbl.cell_end.dtype == torch.int32
    np.testing.assert_array_equal(tbl.pos.numpy(), pos.numpy()[order])
    np.testing.assert_array_equal(tbl.vel.numpy(), vel.numpy()[order])
    no_vel = cells.cell_table(skey, order, pos, None, NUM_CELLS)
    assert no_vel.vel is None
    assert torch.equal(no_vel.cell_start, tbl.cell_start)


def test_cell_table_rejects_other_devices():
    skey, order, pos, vel = (t.to("meta") for t in table_fixture("empty_head"))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        cells.cell_table(skey, order, pos, vel, NUM_CELLS)


# ---------------------------------------------------------------------------
# against the JAX package's sorts
# ---------------------------------------------------------------------------

HALF, H = (3.0, 3.0, 3.0), 0.28
ACTIVE = {"all_faces": (1, 1, 1, 1, 1, 1), "open_top": (1, 1, 1, 0, 1, 1)}


def ghost_shell_numpy(seed=1):
    """512 fluid particles in a box of half 3 with the ghost shell, as
    tests/test_pallas_engine.py:46-69, with random velocities so the
    velocity gather is seen."""
    spawn = TS.concat_spawns(
        TS.spawn_standard(512, h=H, box_half=HALF, seed=seed),
        TS.spawn_ghost_box_shell(h=H, box_half=HALF))
    state = TS.state_from_spawn(spawn, device="cpu")
    d = {f.name: getattr(state, f.name).numpy().copy()
         for f in dataclasses.fields(state)}
    d["vel"][:spawn.count] = np.random.default_rng(seed).normal(
        size=(spawn.count, 3)).astype(np.float32)
    return d


def both(active):
    """The ghost-shell state and params in both packages, and the dims."""
    from sph_tpu.core import params as JP
    from sph_tpu.core import state as JS
    from sph_tpu_torch.core.convert import state_from_numpy

    d = ghost_shell_numpy()
    js = JS.ParticleState(**d)
    jp = JP.FluidParams.default(
        h=H, box_half=np.asarray(HALF, np.float32),
        ghost_face_active=np.asarray(active, np.int32)).derive_mass()
    tp = TP.FluidParams.default(
        device="cpu", h=H, box_half=np.asarray(HALF, np.float32),
        ghost_face_active=active).derive_mass()
    dims = TP.compute_grid_dims(TP.SHAPE_BOX, HALF, (0, 0, 0), H)
    return js, jp, state_from_numpy(d, device="cpu"), tp, dims


def test_cell_table_matches_jax_sort_and_slots():
    from sph_tpu.core import params as JP
    from sph_tpu.neighbors import planes as PL

    js, jp, ts, tp, dims = both(ACTIVE["all_faces"])
    geom = PL.geom_for(JP.SimConfig(n=js.n, grid_dims=dims))
    jkey = PL.compute_keys_ymajor(js.pos, js.fluid_mask(), jp, geom)
    want = PL.sort_particles(js, jkey, js.contrib_mask(jp.ghost_face_active))
    rows = cells.build(ts, tp, dims)
    key = rows.key.numpy()
    np.testing.assert_array_equal(key, np.asarray(want.key))
    np.testing.assert_array_equal(rows.state.pos.numpy(), np.asarray(want.pos))
    np.testing.assert_array_equal(rows.state.vel.numpy(), np.asarray(want.vel))
    # the slot #3 writes each row to is its in-cell rank
    fl = key < int(np.prod(dims))
    assert fl.sum() == 512
    slot = np.nonzero(fl)[0] - rows.cell_start.numpy()[key[fl]]
    np.testing.assert_array_equal(slot, np.asarray(want.rank)[fl])
    np.testing.assert_array_equal(
        (rows.cell_end - rows.cell_start).numpy(),
        np.bincount(key[fl], minlength=int(np.prod(dims))))


@pytest.mark.parametrize("faces", list(ACTIVE))
def test_ghost_structure_matches_jax_ghost_sort(faces):
    import jax.numpy as jnp
    from jax import lax
    from sph_tpu.core import params as JP
    from sph_tpu.neighbors import planes as PL

    js, jp, ts, tp, dims = both(ACTIVE[faces])
    geom = PL.geom_for(JP.SimConfig(n=js.n, grid_dims=dims))
    # the key/rank sort of planes.build_ghost_tables
    contrib = js.contrib_mask(jp.ghost_face_active)
    gmask = (js.valid > 0) & (js.ghost > 0) & contrib
    jkey = PL.compute_keys_ymajor(js.pos, gmask, jp, geom)
    skey, px, py, pz = lax.sort(
        (jkey, js.pos[:, 0], js.pos[:, 1], js.pos[:, 2]),
        dimension=0, num_keys=1, is_stable=True)
    rank = np.asarray(PL._ranks(skey))
    g = int(jnp.sum(gmask))

    ghosts = cells.build_ghosts(ts, tp, dims)
    assert ghosts.count == g
    assert g == (4374 if faces == "all_faces" else 4374 - 729)
    np.testing.assert_array_equal(ghosts.pos.numpy(),
                                  np.stack([px, py, pz], -1)[:g])
    key = cells.compute_keys_ymajor(ghosts.pos, torch.ones(g, dtype=bool),
                                    tp, dims).numpy()
    np.testing.assert_array_equal(key, np.asarray(skey)[:g])
    slot = np.arange(g) - ghosts.ghost_start.numpy()[key]
    np.testing.assert_array_equal(slot, rank[:g])
    np.testing.assert_array_equal(
        (ghosts.ghost_end - ghosts.ghost_start).numpy(),
        np.bincount(key, minlength=int(np.prod(dims))))


@pytest.mark.parametrize("faces", list(ACTIVE))
def test_ghost_records_are_the_oracles_ghost_sources(faces):
    """The ghost structure's source records for the force sweep: its sorted
    positions with the ghost source of the JAX all-pairs oracle (rho0, so
    P = 0 by the EOS; v = 0; mass / rho0), ``physics/brute_force.py``."""
    js, jp, ts, tp, dims = both(ACTIVE[faces])
    ghosts = cells.build_ghosts(ts, tp, dims)
    rec = ghosts.records
    assert rec.shape == (2, ghosts.count, 4) and rec.dtype == torch.float32
    assert rec.is_contiguous()
    assert torch.equal(rec[0, :, :3], ghosts.pos)
    rho0 = np.float32(jp.rest_density)
    np.testing.assert_array_equal(rec[0, :, 3].numpy(), rho0)
    assert float(np.maximum(np.float32(jp.gas_constant) * (rho0 - rho0),
                            0)) == 0.0
    np.testing.assert_array_equal(rec[1, :, :3].numpy(), 0.0)
    np.testing.assert_array_equal(rec[1, :, 3].numpy(),
                                  np.float32(jp.mass) / rho0)


# ---------------------------------------------------------------------------
# the kernel against the plain version (CUDA only)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell-table kernel has no CPU mode")
    return torch.device("cuda")


def assert_tables_equal(got, want):
    for f in cells.CellTable._fields:
        a, b = getattr(got, f), getattr(want, f)
        if b is None:
            assert a is None, f
        else:
            assert torch.equal(a.cpu(), b.cpu()), f


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(OCCUPANCY))
def test_cell_table_kernel_bit_equal_on_fixtures(cuda, name):
    args = table_fixture(name, device=cuda)
    cells.reset_launches()
    for vel in (args[3], None):
        got = cells.cell_table(*args[:3], vel, NUM_CELLS)
        want = cells.cell_table_plain(*args[:3], vel, NUM_CELLS)
        torch.cuda.synchronize()
        assert_tables_equal(got, want)
    assert cells.LAUNCHES == {"cell_table": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("faces", list(ACTIVE))
def test_cell_table_kernel_bit_equal_on_ghost_shell(cuda, faces):
    from sph_tpu_torch.core.convert import state_from_numpy

    d = ghost_shell_numpy()
    tp = TP.FluidParams.default(
        device=cuda, h=H, box_half=np.asarray(HALF, np.float32),
        ghost_face_active=ACTIVE[faces]).derive_mass()
    dims = TP.compute_grid_dims(TP.SHAPE_BOX, HALF, (0, 0, 0), H)
    outs = {}
    for dev in ("cpu", cuda):
        ts = state_from_numpy(d, device=dev)
        p = tp if dev == cuda else TP.FluidParams.default(
            device="cpu", h=H, box_half=np.asarray(HALF, np.float32),
            ghost_face_active=ACTIVE[faces]).derive_mass()
        rows = cells.build(ts, p, dims)
        outs[str(dev)] = (rows, cells.build_ghosts(ts, p, dims))
    torch.cuda.synchronize()
    (r_cpu, g_cpu), (r_gpu, g_gpu) = outs["cpu"], outs["cuda"]
    for f in ("key", "cell_start", "cell_end"):
        assert torch.equal(getattr(r_gpu, f).cpu(), getattr(r_cpu, f)), f
    for f in ("pos", "vel", "orig_id"):
        assert torch.equal(getattr(r_gpu.state, f).cpu(),
                           getattr(r_cpu.state, f)), f
    for a, b in zip(g_gpu, g_cpu):
        assert torch.equal(a.cpu(), b)
