"""The cell table and the ghost structure (sph_tpu_torch.neighbors.cells).

CPU: the plain cell table has ``torch.searchsorted``'s range semantics
(empty cells at the head, middle and tail of the grid, no rows at all, one
row, a crowd in one cell, every cell occupied, a gap of thousands of empty
cells, sizes that are no multiple of 32) and carries every other column of
the rows; ``cells.build`` moves every field with its row; and the sorted
rows, ranges and in-cell slots agree with the JAX package's sorts (``planes.sort_particles`` for the fluid,
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
# cell occupancy per fixture (one count per cell); every fixture adds rows
# outside the table (key = the number of cells) after the table rows, except
# "no_rows"
OCCUPANCY = {
    "empty_head": [0, 0, 0, 2, 1, 3, 1, 1, 2, 1, 1, 1],
    "empty_middle": [1, 2, 0, 0, 0, 3, 1, 0, 2, 1, 1, 1],
    "empty_tail": [2, 1, 1, 3, 0, 0, 0, 0, 0, 0, 0, 0],
    "no_table_rows": [0] * NUM_CELLS,       # no fluid row at all
    "no_rows": [0] * NUM_CELLS,
    "one_row": [0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0],
    "one_cell_crowd": [0] * 5 + [700] + [0] * 6,
    "every_cell_occupied": [1 + (3 * c) % 4 for c in range(37)],
    # the first and the last cell, thousands of empty cells between
    "ends_occupied": [2] + [0] * 5001 + [3],
    # neither the rows (131 + 3) nor the cells (101) a multiple of 32
    "ragged": [(7 * c) % 3 for c in range(100)] + [32],
}
assert sum(OCCUPANCY["ragged"]) == 131


def table_fixture(name, seed=0, device="cpu"):
    """(skey, order, pos, vel, num_cells) for one occupancy fixture."""
    counts = np.asarray(OCCUPANCY[name])
    nc = counts.shape[0]
    outside = 0 if name == "no_rows" else 3
    skey = np.concatenate([np.repeat(np.arange(nc), counts),
                           np.full(outside, nc)]).astype(np.int32)
    rng = np.random.default_rng(seed)
    n = skey.shape[0]
    order = rng.permutation(n).astype(np.int64)
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    vel = rng.normal(size=(n, 3)).astype(np.float32)
    return tuple(torch.as_tensor(a, device=device)
                 for a in (skey, order, pos, vel)) + (nc,)


def carried_fixture(n, seed=1, device="cpu"):
    """Columns of every kind the state has: [n, 3] float32, [n] float32 and
    [n] int32 (negative values and the largest included)."""
    rng = np.random.default_rng(seed)
    cols = [rng.normal(size=(n, 3)).astype(np.float32),
            rng.normal(size=n).astype(np.float32),
            rng.integers(-2**31, 2**31 - 1, n).astype(np.int32),
            np.arange(n, dtype=np.int32)]
    return [torch.as_tensor(c, device=device) for c in cols]


@pytest.mark.parametrize("name", list(OCCUPANCY))
def test_cell_table_plain_has_searchsorted_ranges(name):
    skey, order, pos, vel, nc = table_fixture(name)
    tbl = cells.cell_table(skey, order, pos, vel, nc)
    counts = np.asarray(OCCUPANCY[name])
    before = np.concatenate([[0], np.cumsum(counts)[:-1]])
    # start = first row with key >= c, end = first row with key > c: an
    # empty cell sits at its insertion point, never at 0 past a full cell
    np.testing.assert_array_equal(tbl.cell_start.numpy(), before)
    np.testing.assert_array_equal(tbl.cell_end.numpy(), before + counts)
    assert tbl.cell_start.dtype == tbl.cell_end.dtype == torch.int32
    np.testing.assert_array_equal(tbl.pos.numpy(), pos.numpy()[order])
    np.testing.assert_array_equal(tbl.vel.numpy(), vel.numpy()[order])
    assert tbl.carried == ()
    no_vel = cells.cell_table(skey, order, pos, None, nc)
    assert no_vel.vel is None
    assert torch.equal(no_vel.cell_start, tbl.cell_start)


@pytest.mark.parametrize("name", list(OCCUPANCY))
def test_cell_table_plain_carries_every_column(name):
    """``carried[k]`` is ``carry[k][order]`` for every shape and dtype, and
    the table itself does not depend on what is carried."""
    skey, order, pos, vel, nc = table_fixture(name)
    carry = carried_fixture(skey.shape[0])
    tbl = cells.cell_table(skey, order, pos, vel, nc, carry)
    assert len(tbl.carried) == len(carry)
    for got, col in zip(tbl.carried, carry):
        assert got.dtype == col.dtype and got.shape == col.shape
        np.testing.assert_array_equal(got.numpy(), col.numpy()[order])
    for a, b in zip(tbl[:4], cells.cell_table(skey, order, pos, vel, nc)):
        assert torch.equal(a, b)


def test_cell_table_rejects_other_devices():
    skey, order, pos, vel = (t.to("meta")
                             for t in table_fixture("empty_head")[:4])
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
# cells.build: every field moves with its row
# ---------------------------------------------------------------------------

LATTICE_H, LATTICE_HALF = 0.4, (1.2, 1.2, 1.2)     # grid 8 x 8 x 8


def _rows_in_cells(cells_xyz, seed):
    """One jittered fluid row in each listed cell of the 8 x 8 x 8 grid."""
    rng = np.random.default_rng(seed)
    idx = np.asarray(cells_xyz, np.float32).reshape(-1, 3)
    gmin = -(np.asarray(LATTICE_HALF, np.float32) + np.float32(LATTICE_H))
    pos = (gmin + (idx + 0.05 + 0.9 * rng.random(idx.shape)) * LATTICE_H)
    n = pos.shape[0]
    return TS.SpawnResult(
        pos=pos.astype(np.float32), vel=np.zeros((n, 3), np.float32),
        ghost=np.zeros((n,), np.int32), face=np.full((n,), -1, np.int32),
        color_group=(np.arange(n) % 2).astype(np.int32), count=n)


BUILD_STATES = {
    "ghost_shell": lambda: TS.concat_spawns(
        TS.spawn_standard(512, h=LATTICE_H, box_half=LATTICE_HALF, seed=1),
        TS.spawn_ghost_box_shell(h=LATTICE_H, box_half=LATTICE_HALF)),
    "no_fluid_row": lambda: TS.spawn_ghost_box_shell(
        h=LATTICE_H, box_half=LATTICE_HALF),
    "one_fluid_row": lambda: _rows_in_cells([(3, 1, 3)], 2),
    "every_row_in_one_cell": lambda: _rows_in_cells([(4, 1, 4)] * 300, 3),
    "every_cell_occupied": lambda: _rows_in_cells(
        [(x, y, z) for y in range(8) for z in range(8) for x in range(8)], 4),
    "first_and_last_cell": lambda: _rows_in_cells([(0, 0, 0), (7, 7, 7)], 5),
}


def build_state(name, device="cpu"):
    """A state whose every field is distinct per row, its params and the
    grid dims."""
    state = TS.state_from_spawn(BUILD_STATES[name](), device="cpu")
    rng = np.random.default_rng(7)
    n = state.n
    d = {f.name: getattr(state, f.name).numpy().copy()
         for f in dataclasses.fields(state)}
    for f in ("vel", "acc"):
        d[f] = rng.normal(size=(n, 3)).astype(np.float32)
    for f in ("density", "pressure", "foam"):
        d[f] = rng.random(n).astype(np.float32)
    d["active"] = rng.integers(0, 2, n).astype(np.int32)
    from sph_tpu_torch.core.convert import state_from_numpy
    params = TP.FluidParams.default(
        device=device, h=LATTICE_H,
        box_half=np.asarray(LATTICE_HALF, np.float32)).derive_mass()
    dims = TP.compute_grid_dims(TP.SHAPE_BOX, LATTICE_HALF, (0, 0, 0),
                                LATTICE_H)
    assert dims == (8, 8, 8)
    return state_from_numpy(d, device=device), params, dims


@pytest.mark.parametrize("name", list(BUILD_STATES))
def test_build_moves_every_field_with_its_row(name):
    """``cells.build``'s state is the state gathered through the stable key
    sort, field by field and bit for bit (what ten torch gathers beside the
    table gave before the table carried the columns), and its ranges are
    the key counts."""
    state, params, dims = build_state(name)
    rows = cells.build(state, params, dims)
    skey, order = cells.fluid_sort(state, params, dims)
    assert torch.equal(rows.key, skey)
    for f in dataclasses.fields(state):
        got, col = getattr(rows.state, f.name), getattr(state, f.name)
        assert got.dtype == col.dtype, f.name
        assert torch.equal(got, col[order]), f.name
    nc = int(np.prod(dims))
    counts = np.bincount(skey.numpy(), minlength=nc + 1)[:nc]
    np.testing.assert_array_equal(
        (rows.cell_end - rows.cell_start).numpy(), counts)
    assert counts.sum() == int(state.fluid_mask().sum())
    want = {"no_fluid_row": 0, "one_fluid_row": 1, "first_and_last_cell": 2,
            "every_row_in_one_cell": 300, "every_cell_occupied": 512}
    if name in want:
        assert counts.sum() == want[name]
    if name == "first_and_last_cell":
        assert counts[0] == counts[-1] == 1


def test_ghost_near_is_the_3x3x3_block_of_the_ghost_cells():
    """``GhostRows.near`` marks exactly the cells whose 3 x 3 x 3 block
    holds a ghost, so every fluid position within h of a ghost lies in a
    marked cell: the density kernel may skip the ghost ranges elsewhere."""
    state, params, dims = build_state("ghost_shell")
    g = cells.build_ghosts(state, params, dims)
    nx, ny, nz = dims
    has = (g.ghost_end > g.ghost_start).numpy().reshape(ny, nz, nx)
    want = np.zeros_like(has)
    for y, z, x in zip(*np.nonzero(has)):
        want[max(y - 1, 0):y + 2, max(z - 1, 0):z + 2,
             max(x - 1, 0):x + 2] = True
    assert g.near.dtype == torch.uint8 and g.near.shape == (nx * ny * nz,)
    np.testing.assert_array_equal(g.near.numpy().reshape(ny, nz, nx), want)
    assert 0 < want.sum() < want.size
    # points on a fine lattice over the box: one within h of a ghost has a
    # marked cell
    t = torch.linspace(-1.2, 1.2, 25)
    pts = torch.cartesian_prod(t, t, t)
    key = cells.compute_keys_ymajor(pts, torch.ones(len(pts), dtype=bool),
                                    params, dims)
    close = (torch.cdist(pts, g.pos) < LATTICE_H).any(1)
    assert int(close.sum()) > 1000 and int((~close).sum()) > 1000
    assert bool(g.near[key[close].long()].all())


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
        elif f == "carried":
            assert len(a) == len(b), f
            for x, y in zip(a, b):
                assert x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu()), f
        else:
            assert torch.equal(a.cpu(), b.cpu()), f


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(OCCUPANCY))
def test_cell_table_kernel_bit_equal_on_fixtures(cuda, name):
    """With and without vel, with and without carried columns."""
    skey, order, pos, vel, nc = table_fixture(name, device=cuda)
    carry = carried_fixture(skey.shape[0], device=cuda)
    cells.reset_launches()
    for v in (vel, None):
        for cols in ((), carry):
            got = cells.cell_table(skey, order, pos, v, nc, cols)
            want = cells.cell_table_plain(skey, order, pos, v, nc, cols)
            torch.cuda.synchronize()
            assert_tables_equal(got, want)
    assert cells.LAUNCHES == {"cell_table": 4}


@pytest.mark.cuda
def test_cell_table_kernel_takes_strided_columns(cuda):
    """Columns that are views of a wider row buffer, as the emitted-row
    transport's are, move like contiguous ones."""
    skey, order, pos, vel, nc = table_fixture("ragged", device=cuda)
    n = skey.shape[0]
    per = torch.as_tensor(np.random.default_rng(3).normal(
        size=(n, 16)).astype(np.float32), device=cuda)
    views = [per[:, 6:9], per[:, 9]]
    got = cells.cell_table(skey, order, per[:, 0:3], per[:, 3:6], nc, views)
    want = cells.cell_table_plain(skey, order, per[:, 0:3], per[:, 3:6], nc,
                                  views)
    torch.cuda.synchronize()
    assert_tables_equal(got, want)
    assert all(t.is_contiguous() for t in (got.pos, got.vel, *got.carried))
    with pytest.raises(ValueError, match="lie together"):
        cells.cell_table(skey, order, pos.t().contiguous().t(), vel, nc)
    with pytest.raises(ValueError, match="dtype"):
        cells.cell_table(skey, order, pos, vel, nc, [skey.long()])
    with pytest.raises(ValueError, match="aligned"):
        cells.cell_table(torch.cat([skey[:1], skey])[1:], order, pos, vel, nc)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(BUILD_STATES))
def test_build_on_cuda_matches_cpu(cuda, name):
    """One kernel launch, no gather: every field and the ranges bit-equal
    to the plain version's."""
    outs = {}
    for dev in ("cpu", cuda):
        state, params, dims = build_state(name, device=dev)
        cells.reset_launches()
        outs[str(dev)] = cells.build(state, params, dims)
    torch.cuda.synchronize()
    assert cells.LAUNCHES == {"cell_table": 1}
    want, got = outs["cpu"], outs["cuda"]
    for f in ("key", "cell_start", "cell_end"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    for f in dataclasses.fields(want.state):
        assert torch.equal(getattr(got.state, f.name).cpu(),
                           getattr(want.state, f.name)), f.name


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
