"""sph_tpu_torch.core against sph_tpu.core: spawn, params, grid, keys,
sort and cell ranges.  The same numpy inputs go through both packages."""
import dataclasses

import numpy as np
import pytest
import torch

from sph_tpu.core import params as JP
from sph_tpu.core import state as JS
from sph_tpu.neighbors import planes as PL
from sph_tpu_torch.app import configs as TCFG
from sph_tpu_torch.core import params as TP
from sph_tpu_torch.core import state as TS
from sph_tpu_torch.core.convert import params_from_numpy, state_from_numpy
from sph_tpu_torch.neighbors import cells


def to_numpy(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def assert_spawn_equal(a, b):
    assert a.count == b.count
    for f in ("pos", "vel", "ghost", "face", "color_group"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("mode", ["ignore", "local", "aabb"])
def test_spawn_bit_identical_rotation_modes(mode):
    kw = dict(h=0.28, box_half=(4.0, 3.0, 3.5), seed=5,
              box_euler_deg=(20.0, 0.0, 30.0), spawn_rotation=mode,
              mix_pattern=2)
    assert_spawn_equal(TS.spawn_standard(3000, **kw),
                       JS.spawn_standard(3000, **kw))


@pytest.mark.parametrize("shape", [TP.SHAPE_SPHERE, TP.SHAPE_TORUS,
                                   TP.SHAPE_STAR, TP.SHAPE_TREFOIL])
def test_spawn_bit_identical_shapes(shape):
    kw = dict(h=0.3, box_half=(3.0, 1.2, 1.0), shape_type=shape, seed=2,
              mix_pattern=1)
    assert_spawn_equal(TS.spawn_standard(5000, **kw),
                       JS.spawn_standard(5000, **kw))


def test_spawn_bit_identical_default_131k():
    kw = dict(h=0.28, box_half=(9.5, 9.5, 9.5), seed=0)
    t = TS.spawn_standard(131072, **kw)
    assert t.count == 131072
    assert_spawn_equal(t, JS.spawn_standard(131072, **kw))


@pytest.mark.parametrize("half", [(3.0, 3.0, 3.0), (18.5, 18.5, 18.5)])
def test_ghost_shell_bit_identical(half):
    t = TS.spawn_ghost_box_shell(h=0.28, box_half=half)
    assert_spawn_equal(t, JS.spawn_ghost_box_shell(h=0.28, box_half=half))
    assert t.count == {3.0: 4374, 18.5: 147894}[half[0]]
    assert np.all(t.ghost == 1)
    np.testing.assert_array_equal(np.bincount(t.face), [t.count // 6] * 6)


def test_state_from_spawn_matches():
    spawn = TS.concat_spawns(TS.spawn_standard(700, seed=3),
                             TS.spawn_standard(300, seed=4))
    t = TS.state_from_spawn(spawn, device="cpu")
    j = to_numpy(JS.state_from_spawn(spawn))
    assert t.n == 1024
    for k, v in j.items():
        np.testing.assert_array_equal(getattr(t, k).numpy(), v, err_msg=k)
    np.testing.assert_array_equal(t.fluid_mask().numpy(), t.valid.numpy() > 0)


ENTRY_POINTS = {
    "configs.build": lambda: TCFG.build("dam_break_8k"),
    "FluidParams.default": lambda: TP.FluidParams.default(),
    "state_from_spawn": lambda: TS.state_from_spawn(
        TS.spawn_standard(100, seed=0)),
    "params_from_numpy": lambda: params_from_numpy(
        to_numpy(TP.FluidParams.default(device="cpu"))),
    "state_from_numpy": lambda: state_from_numpy(to_numpy(
        TS.state_from_spawn(TS.spawn_standard(100, seed=0), device="cpu"))),
}


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_entry_points_need_a_card_or_an_explicit_cpu(monkeypatch, entry):
    """With no device named, an entry point goes to the card; with no card
    it raises and tells the caller to pass device="cpu"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ENTRY_POINTS[entry]()


def test_resolve_defaults_to_cuda(monkeypatch):
    from sph_tpu_torch.core.device import resolve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve(None) == torch.device("cuda")
    assert resolve("cpu") == torch.device("cpu")
    assert resolve(torch.device("cuda", 1)) == torch.device("cuda", 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve("cpu") == torch.device("cpu")


def test_params_default_and_derive_mass():
    kw = dict(h=0.31, box_half=np.asarray([2.0, 3.0, 4.0], np.float32),
              surface_tension=0.05)
    t = TP.FluidParams.default(device="cpu", **kw).derive_mass()
    j = to_numpy(JP.FluidParams.default(**kw).derive_mass())
    for k, v in j.items():
        got = np.asarray(getattr(t, k))
        np.testing.assert_allclose(got, v, rtol=1e-6, err_msg=k)
        assert got.shape == v.shape, k
    with pytest.raises(KeyError):
        TP.FluidParams.default(device="cpu", no_such_field=1.0)


def test_convert_roundtrip():
    jp = JP.FluidParams.default(shape_type=3).derive_mass()
    tp = params_from_numpy(to_numpy(jp), device="cpu")
    assert tp.shape_type == 3
    assert tp.ghost_face_active.dtype == torch.int32
    assert tp.h.dtype == torch.float32 and tp.h.shape == ()
    js = JS.state_from_spawn(JS.spawn_standard(300, seed=1))
    ts = state_from_numpy(to_numpy(js), device="cpu")
    for k, v in to_numpy(js).items():
        np.testing.assert_array_equal(getattr(ts, k).numpy(), v, err_msg=k)
    with pytest.raises(KeyError):
        params_from_numpy({"h": np.float32(0.3)}, device="cpu")


@pytest.mark.parametrize("euler", [(0.0, 0.0, 0.0), (20.0, 0.0, 30.0),
                                   (-35.0, 50.0, 10.0)])
def test_rotation_matrix(euler):
    e = np.asarray(euler, np.float32)
    got = TP.rotation_matrix(torch.as_tensor(e)).numpy()
    np.testing.assert_allclose(got, np.asarray(JP.rotation_matrix(e)),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(TP.rotation_matrix_np(e),
                                  JP.rotation_matrix_np(e))


@pytest.mark.parametrize("half,euler,h", [
    ((7.0, 7.0, 7.0), (0, 0, 0), 0.28),
    ((9.5, 9.5, 9.5), (0, 0, 0), 0.28),
    ((15.0, 15.0, 15.0), (20, 0, 30), 0.28),
    ((41.0, 41.0, 41.0), (0, 0, 0), 0.4),
])
def test_grid_dims(half, euler, h):
    for shape in (TP.SHAPE_BOX, TP.SHAPE_TORUS, TP.SHAPE_CAPSULE):
        assert (TP.compute_grid_dims(shape, half, euler, h)
                == JP.compute_grid_dims(shape, half, euler, h))
        np.testing.assert_array_equal(
            TP.effective_half_np(shape, np.asarray(half)),
            JP.effective_half_np(shape, np.asarray(half)))


def _dam_break(n=2048, half=(7.0, 7.0, 7.0), seed=7):
    spawn = JS.spawn_standard(n, box_half=half, seed=seed)
    js = JS.state_from_spawn(spawn)
    jp = JP.FluidParams.default(
        box_half=np.asarray(half, np.float32)).derive_mass()
    dims = JP.compute_grid_dims(0, half, (0, 0, 0), 0.28)
    return js, jp, dims


def test_grid_cell_coords_and_keys_match_planes():
    js, jp, dims = _dam_break()
    ts = state_from_numpy(to_numpy(js), device="cpu")
    tp = params_from_numpy(to_numpy(jp), device="cpu")
    np.testing.assert_array_equal(
        TP.grid_cell_coords(ts.pos, tp, dims).numpy(),
        np.asarray(JP.grid_cell_coords(js.pos, jp, dims)))
    geom = PL.geom_for(JP.SimConfig(n=js.n, grid_dims=dims))
    fluid = js.valid > 0
    want = np.asarray(PL.compute_keys_ymajor(js.pos, fluid, jp, geom))
    got = cells.compute_keys_ymajor(ts.pos, ts.fluid_mask(), tp, dims)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_sort_and_cell_ranges():
    js, jp, dims = _dam_break()
    ts = state_from_numpy(to_numpy(js), device="cpu")
    tp = params_from_numpy(to_numpy(jp), device="cpu")
    rows = cells.build(ts, tp, dims)
    nc = int(np.prod(dims))
    key = rows.key.numpy()
    assert np.all(np.diff(key) >= 0)
    # stable: equal keys keep spawn order, and the sort matches the JAX
    # engine's 9-operand lax.sort
    geom = PL.geom_for(JP.SimConfig(n=js.n, grid_dims=dims))
    contrib = js.contrib_mask(jp.ghost_face_active)
    jkey = PL.compute_keys_ymajor(js.pos, js.valid > 0, jp, geom)
    jsorted = PL.sort_particles(js, jkey, contrib)
    np.testing.assert_array_equal(key, np.asarray(jsorted.key))
    np.testing.assert_array_equal(rows.state.pos.numpy(),
                                  np.asarray(jsorted.pos))
    np.testing.assert_array_equal(
        rows.state.orig_id.numpy(),
        np.asarray(PL.unpack_meta(jsorted.meta).orig_id))
    # padding sorts last with key num_cells
    n_fluid = int(ts.fluid_mask().sum())
    assert np.all(key[n_fluid:] == nc) and np.all(key[:n_fluid] < nc)
    # ranges: cell c holds exactly rows [start, end)
    start, end = rows.cell_start.numpy(), rows.cell_end.numpy()
    assert rows.cell_start.dtype == torch.int32 and start.shape == (nc,)
    counts = np.bincount(key[:n_fluid], minlength=nc)
    np.testing.assert_array_equal(end - start, counts)
    for c in np.nonzero(counts)[0][:200]:
        assert np.all(key[start[c]:end[c]] == c)
