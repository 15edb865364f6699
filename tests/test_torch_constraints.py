"""The container's ten shapes, the terrain and the channel
(sph_tpu_torch.physics.constraints, core.params.effective_half) against
``sph_tpu`` on the same numpy inputs: each projector and ``apply_container``
for every shape under two rotations, the analytic cases of
``tests/test_constraints.py``, ``effective_half`` and the cell keys for
every shape, the heightfield and the channel; the cell engine's substep,
which applies the container in the pass that reassembles its sweeps'
outputs, against reassembly and then ``apply_container``, for every shape
with and without ghosts; the container pass's wrappers on other devices
and its launch count on the CPU.

CUDA (marker ``cuda``, skipped without a card): the same functions on CUDA
tensors against the CPU, the container kernel (``csrc/container.cu``)
alone and inside the reassembly pass, for every shape under both
rotations.  The inputs are built with the port's own numpy
code (its spawn and terrain are the JAX package's, bit for bit) and JAX is
imported inside the tests that compare with it, so the CUDA tests also run
where JAX is not installed:

    python -m pytest tests/test_torch_constraints.py -q -m cuda --noconftest
"""
import dataclasses

import numpy as np
import pytest
import torch

from sph_tpu_torch.core import params as TP
from sph_tpu_torch.core import state as TS
from sph_tpu_torch.core.convert import state_from_numpy
from sph_tpu_torch.engine import step as TSTEP
from sph_tpu_torch.neighbors import sweeps
from sph_tpu_torch.physics import constraints as TC
from sph_tpu_torch.scene import river as TRV
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


# float32 projections of points within ~10 of the origin
POS_ATOL, NRM_ATOL, VEL_ATOL = 2e-5, 2e-5, 1e-4
# each shape with the half extents SurpriseMe gives it
# (sph_tpu/scene/art_presets.py:207-211); the art presets use these or
# close ones for shapes 0-6
HALVES = {
    TP.SHAPE_BOX: (7.0, 7.0, 7.0), TP.SHAPE_SPHERE: (7.0, 7.0, 7.0),
    TP.SHAPE_CYLINDER: (6.0, 6.0, 6.0), TP.SHAPE_TORUS: (7.0, 2.2, 0.0),
    TP.SHAPE_CAPSULE: (4.0, 5.0, 0.0), TP.SHAPE_HOURGLASS: (6.0, 7.0, 1.4),
    TP.SHAPE_EGG: (5.5, 7.5, 0.0), TP.SHAPE_STAR: (6.5, 6.5, 6.5),
    TP.SHAPE_SUPERELLIPSOID: (6.0, 6.0, 6.0),
    TP.SHAPE_TREFOIL: (6.5, 1.6, 0.0),
}
SHAPES = sorted(HALVES)
ROTATIONS = {"upright": (0.0, 0.0, 0.0), "tilted": (20.0, 35.0, -15.0)}
AUX = (5.0, 0.35, 2.5)
CENTER = (0.5, -0.25, 0.3)


def params_kw(shape, euler):
    f32 = lambda v: np.asarray(v, np.float32)  # noqa: E731
    return dict(shape_type=shape, box_half=f32(HALVES[shape]),
                box_euler_deg=f32(euler), box_center=f32(CENTER),
                wall_restitution=0.3, wall_friction=0.1)


def port_params(shape, euler=(0.0, 0.0, 0.0), device="cpu"):
    return TP.FluidParams.default(device=device,
                                  **params_kw(shape, euler)).derive_mass()


def jax_params(shape, euler=(0.0, 0.0, 0.0)):
    from sph_tpu.core import params as JP
    return JP.FluidParams.default(**params_kw(shape, euler)).derive_mass()


def jax_state(d):
    import jax.numpy as jnp
    from sph_tpu.core.state import ParticleState
    return ParticleState(**{k: jnp.asarray(v) for k, v in d.items()})


def points(shape, n=600, seed=0):
    """Container-local points over 1.3x the shape's effective half
    extents: inside, near and outside the surface."""
    eh = TP.effective_half_np(shape, np.asarray(HALVES[shape], np.float32))
    rng = np.random.default_rng(seed + shape)
    pts = rng.uniform(-1.3, 1.3, (n, 3)) * eh
    if shape == TP.SHAPE_TREFOIL:
        # half of them around the knot, whose tube the box barely samples
        S, r = HALVES[shape][:2]
        knot = S * TC._TREFOIL_BASE[rng.integers(0, 48, n // 2)]
        pts[:n // 2] = knot + rng.uniform(-1.3 * r, 1.3 * r, (n // 2, 3))
    return pts.astype(np.float32)


def scattered(shape, euler, n=600, seed=0):
    """A state (numpy dict of its fields) of ``points`` moved into the
    world frame, with random velocities, some ghosts and 40 padding rows
    outside the container."""
    rot = TP.rotation_matrix_np(euler)
    world = points(shape, n, seed) @ rot.T + np.asarray(CENTER, np.float32)
    rng = np.random.default_rng(100 + seed)
    spawn = TS.SpawnResult(
        pos=world.astype(np.float32),
        vel=rng.standard_normal((n, 3)).astype(np.float32) * 3.0,
        ghost=(rng.uniform(size=n) > 0.9).astype(np.int32),
        face=np.full((n,), -1, np.int32),
        color_group=np.zeros((n,), np.int32), count=n)
    st = TS.state_from_spawn(spawn, pad_to=n + 40, device="cpu")
    d = {f.name: getattr(st, f.name).numpy().copy()
         for f in dataclasses.fields(st)}
    d["pos"][n:] = (20.0, 0.0, 0.0)
    return d


def close(got, want, atol, name=""):
    np.testing.assert_allclose(got.numpy() if torch.is_tensor(got) else got,
                               np.asarray(want), rtol=0, atol=atol,
                               err_msg=name)


@pytest.mark.parametrize("rotation", list(ROTATIONS))
@pytest.mark.parametrize("shape", SHAPES, ids=TP.SHAPE_NAMES)
def test_project_shape_matches_jax(shape, rotation):
    """Each projector on points inside, near and outside its shape: the
    same hits, surface points and normals."""
    import jax.numpy as jnp
    from sph_tpu.physics import constraints as JC
    jp = jax_params(shape, ROTATIONS[rotation])
    pts = points(shape)
    jq, jn, jhit = JC.project_shape(jnp.asarray(pts), jp.shape_type,
                                    jp.box_half, jp.shape_aux)
    tp = port_params(shape, ROTATIONS[rotation])
    tq, tn, thit = TC.project_shape(torch.as_tensor(pts), tp.shape_type,
                                    tp.box_half, tp.shape_aux)
    np.testing.assert_array_equal(thit.numpy(), np.asarray(jhit))
    assert 30 < int(thit.sum()) < len(pts) - 30
    close(tq, jq, POS_ATOL, "q")
    close(tn, jn, NRM_ATOL, "n")


@pytest.mark.parametrize("rotation", list(ROTATIONS))
@pytest.mark.parametrize("shape", SHAPES, ids=TP.SHAPE_NAMES)
def test_apply_container_matches_jax(shape, rotation):
    """``apply_container`` on a scattered state: positions and velocities
    as JAX's, ghosts and padding untouched, and every fluid row the pass
    moved now on or inside the shape."""
    from sph_tpu.physics import constraints as JC
    d = scattered(shape, ROTATIONS[rotation])
    want = JC.apply_container(jax_state(d), jax_params(shape,
                                                       ROTATIONS[rotation]))
    ts = state_from_numpy(d, device="cpu")
    tp = port_params(shape, ROTATIONS[rotation])
    got = TC.apply_container(ts, tp)
    close(got.pos, want.pos, POS_ATOL, "pos")
    close(got.vel, want.vel, VEL_ATOL, "vel")
    fixed = (ts.ghost > 0) | (ts.valid == 0)
    assert torch.equal(got.pos[fixed], ts.pos[fixed])
    assert torch.equal(got.vel[fixed], ts.vel[fixed])
    # in the container frame, the fluid is now inside (no hit beyond 1e-4)
    local = (got.pos - tp.box_center) @ TP.rotation_matrix(tp.box_euler_deg)
    q, _, _ = TC.project_shape(local, tp.shape_type, tp.box_half,
                               tp.shape_aux)
    fl = ts.fluid_mask()
    moved = (got.pos != ts.pos).any(-1) & fl
    assert int(moved.sum()) > 30
    off = torch.linalg.vector_norm(q - local, dim=-1)[moved]
    assert float(off.max()) < 1e-4


@pytest.mark.parametrize("shape", SHAPES, ids=TP.SHAPE_NAMES)
def test_effective_half_and_cell_keys_match_jax(shape):
    """``effective_half`` (and with it ``grid_min``) for every shape, equal
    to the numpy one the spawn and the grid dims use, and the cell
    coordinates of a scattered state."""
    from sph_tpu.core import params as JP
    d = scattered(shape, ROTATIONS["tilted"])
    jp = jax_params(shape, ROTATIONS["tilted"])
    tp = port_params(shape, ROTATIONS["tilted"])
    want = np.asarray(JP.effective_half(jp))
    np.testing.assert_array_equal(TP.effective_half(tp).numpy(), want)
    np.testing.assert_array_equal(
        TP.effective_half_np(shape, np.asarray(HALVES[shape], np.float32)),
        want)
    np.testing.assert_array_equal(TP.grid_min(tp).numpy(),
                                  np.asarray(JP.grid_min(jp)))
    dims = TP.compute_grid_dims(shape, HALVES[shape], (0, 0, 0), 0.28)
    np.testing.assert_array_equal(
        TP.grid_cell_coords(torch.as_tensor(d["pos"]), tp, dims).numpy(),
        np.asarray(JP.grid_cell_coords(jax_state(d).pos, jp, dims)))


# --- the analytic cases of tests/test_constraints.py:20-141 ----------------

# (points, shape, half, aux) -> what tests/test_constraints.py checks there
PROJECTION_CASES = {
    "box": ([[10.0, 0.0, 0.0], [0.0, 0.0, 0.0]], 0, [7, 7, 7], AUX),
    "sphere": ([[0.0, 10.0, 0.0]], 1, [5, 0, 0], AUX),
    "cylinder": ([[8.0, 0.0, 0.0], [0.0, 9.0, 0.0]], 2, [5, 6, 0], AUX),
    "torus": ([[6.0, 0.0, 0.0]], 3, [4, 1, 0], AUX),
    "capsule": ([[0.0, 8.0, 0.0]], 4, [2, 3, 0], AUX),
    "egg": ([[4.0, 4.0, 0.0]], 6, [3, 5, 0], AUX),
    "superellipsoid": ([[5.0, 5.0, 5.0]], 8, [3, 4, 0], (5.0, 0.35, 4.0)),
    "trefoil": ([[20.0, 0.0, 0.0]], 9, [2, 0.8, 0], AUX),
}
PROJECTED = {
    "box": [[7, 0, 0], [0, 0, 0]], "sphere": [[0, 5, 0]],
    "cylinder": [[5, 0, 0], [0, 6, 0]], "torus": [[5, 0, 0]],
    "capsule": [[0, 5, 0]],
}


@pytest.mark.parametrize("case", list(PROJECTION_CASES))
def test_projection_cases(case):
    import jax.numpy as jnp
    from sph_tpu.physics import constraints as JC
    pts, shape, half, aux = PROJECTION_CASES[case]
    f32 = lambda v: np.asarray(v, np.float32)  # noqa: E731
    q, n, hit = TC.project_shape(torch.as_tensor(f32(pts)), shape,
                                 torch.as_tensor(f32(half)),
                                 torch.as_tensor(f32(aux)))
    jq, jn, jhit = JC.project_shape(jnp.asarray(f32(pts)), shape,
                                    jnp.asarray(f32(half)),
                                    jnp.asarray(f32(aux)))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    close(q, jq, 1e-5, "q")
    close(n, jn, 1e-5, "n")
    q, n = q.numpy().astype(np.float64), n.numpy()
    assert hit[0] and (case != "box" or not hit[1])
    if case in PROJECTED:
        np.testing.assert_allclose(q[:len(PROJECTED[case])],
                                   PROJECTED[case], atol=1e-5)
    if case == "egg":
        a, b = half[0], half[1]
        g = np.array([2 * q[0][0] / a**2, 2 * q[0][1] / b**2, 0.0])
        np.testing.assert_allclose(n[0], g / np.linalg.norm(g), atol=1e-5)
        assert abs((q[0][0] / a) ** 2 + (q[0][1] / b) ** 2 - 1.0) < 1e-4
    if case == "superellipsoid":
        a, b, ne = half[0], half[1], aux[2]
        f = ((abs(q[0][0]) / a) ** ne + (abs(q[0][1]) / b) ** ne
             + (abs(q[0][2]) / a) ** ne)
        assert abs(f - 1.0) < 1e-3
    if case == "trefoil":
        S, r = half[0], half[1]
        t = 2.0 * np.pi * np.arange(48) / 48.0
        curve = S * np.stack([np.sin(t) + 2 * np.sin(2 * t),
                              0.35 * (-np.sin(3 * t)),
                              np.cos(t) - 2 * np.cos(2 * t)], -1)
        assert abs(np.linalg.norm(curve - q[0], axis=-1).min() - r) < 1e-4


def one_row_state(pos, vel=(0.0, 0.0, 0.0), ghost=0):
    from sph_tpu_torch.core.state import ParticleState
    st = ParticleState.zeros(256, device="cpu")
    pos_t, vel_t = st.pos.clone(), st.vel.clone()
    pos_t[0] = torch.tensor(pos)
    vel_t[0] = torch.tensor(vel)
    valid, gh = st.valid.clone(), st.ghost.clone()
    valid[0], gh[0] = 1, ghost
    return st.replace(pos=pos_t, vel=vel_t, valid=valid, ghost=gh)


def test_container_cases():
    """Reflection with restitution and friction, the rotated box, ghosts
    skipped (``tests/test_constraints.py:98-132``)."""
    tp = TP.FluidParams.default(device="cpu", wall_restitution=0.5,
                                wall_friction=0.1)
    out = TC.apply_container(one_row_state([8.0, 0.0, 0.0], [2.0, 3.0, 0.0]),
                             tp)
    np.testing.assert_allclose(out.pos[0].numpy(), [7, 0, 0], atol=1e-5)
    np.testing.assert_allclose(out.vel[0].numpy(), [-1.0, 2.7, 0.0],
                               atol=1e-5)
    tp = TP.FluidParams.default(device="cpu", box_euler_deg=[0.0, 0.0, 45.0])
    rot = TP.rotation_matrix(tp.box_euler_deg).numpy()
    out = TC.apply_container(one_row_state(
        (rot @ np.array([10.0, 0.0, 0.0], np.float32)).tolist()), tp)
    np.testing.assert_allclose(out.pos[0].numpy(),
                               rot @ np.array([7.0, 0.0, 0.0], np.float32),
                               atol=1e-4)
    tp = TP.FluidParams.default(device="cpu")
    out = TC.apply_container(one_row_state([9.0, 0.0, 0.0], ghost=1), tp)
    np.testing.assert_array_equal(out.pos[0].numpy(), [9, 0, 0])


def test_terrain_collision_case():
    """A flat floor at y = 2 (``tests/test_constraints.py:135-149``)."""
    tp = TP.FluidParams.default(
        device="cpu", terrain_min=[-7.0, -7.0], terrain_size=[14.0, 14.0],
        terrain_restitution=0.5, terrain_friction=0.0)
    terrain = torch.full((64, 64), 2.0)
    out = TC.apply_terrain(one_row_state([0.0, 1.0, 0.0], [0.0, -4.0, 1.0]),
                           terrain, tp)
    assert abs(float(out.pos[0, 1]) - 2.001) < 1e-5
    np.testing.assert_allclose(out.vel[0].numpy(), [0.0, 2.0, 1.0], atol=1e-5)


# --- the river's heightfield and channel ------------------------------------

RIVER_CENTER, RIVER_HALF = (0.0, 0.0, 0.0), (7.0, 7.0, 7.0)


def river_inputs(seed=0, n=1500):
    """A state (numpy dict) scattered over the river box (half 7) and past
    it in x and z, the river's spec (``RiverSpec.random(seed)``) and its
    terrain."""
    spec = TRV.RiverSpec.random(seed)
    terrain = TRV.generate_river_terrain(spec, RIVER_CENTER, RIVER_HALF)
    rng = np.random.default_rng(seed + 7)
    pos = rng.uniform([-8.0, -7.5, -8.0], [8.0, 3.0, 8.0],
                      (n, 3)).astype(np.float32)
    spawn = TS.SpawnResult(
        pos=pos, vel=(rng.standard_normal((n, 3)) * 3.0).astype(np.float32),
        ghost=(rng.uniform(size=n) > 0.95).astype(np.int32),
        face=np.full((n,), -1, np.int32),
        color_group=np.zeros((n,), np.int32), count=n)
    st = TS.state_from_spawn(spawn, device="cpu")
    return ({f.name: getattr(st, f.name).numpy()
             for f in dataclasses.fields(st)}, spec, terrain)


def river_port(d, spec, terrain, device="cpu"):
    """(state, params, terrain) of the port on ``device``."""
    tp = TRV.river_params(TP.FluidParams.default(device=device).derive_mass(),
                          spec, RIVER_CENTER, RIVER_HALF)
    return (state_from_numpy(d, device=device), tp,
            torch.as_tensor(terrain, device=device))


def river_jax(d, spec, terrain):
    """(state, params, terrain) of the JAX package."""
    import jax.numpy as jnp
    from sph_tpu.core import params as JP
    from sph_tpu.scene import river as JR
    jspec = JR.RiverSpec(**dataclasses.asdict(spec))
    jp = JR.river_params(JP.FluidParams.default().derive_mass(), jspec,
                         RIVER_CENTER, RIVER_HALF)
    return jax_state(d), jp, jnp.asarray(terrain)


@pytest.mark.parametrize("seed", [0, 3])
def test_terrain_height_and_normal_match_jax(seed):
    from sph_tpu.physics import constraints as JC
    inputs = river_inputs(seed)
    js, jp, terrain = river_jax(*inputs)
    ts, tp, tt = river_port(*inputs)
    for fn, atol in ((TC.sample_terrain_height, 2e-5),
                     (TC.terrain_normal, 2e-5)):
        jfn = getattr(JC, fn.__name__)
        want = jfn(terrain, js.pos[:, 0], js.pos[:, 2], jp.terrain_min,
                   jp.terrain_size)
        got = fn(tt, ts.pos[:, 0], ts.pos[:, 2], tp.terrain_min,
                 tp.terrain_size)
        close(got, want, atol, fn.__name__)


@pytest.mark.parametrize("seed", [0, 3])
def test_apply_terrain_matches_jax(seed):
    from sph_tpu.physics import constraints as JC
    inputs = river_inputs(seed)
    js, jp, terrain = river_jax(*inputs)
    want = JC.apply_terrain(js, terrain, jp)
    ts, tp, tt = river_port(*inputs)
    got = TC.apply_terrain(ts, tt, tp)
    close(got.pos, want.pos, 2e-5, "pos")
    close(got.vel, want.vel, 1e-4, "vel")
    lifted = (got.pos != ts.pos).any(-1)
    assert 100 < int(lifted.sum()) and not bool(lifted[ts.ghost > 0].any())
    # only y moves
    assert torch.equal(got.pos[:, ::2], ts.pos[:, ::2])


@pytest.mark.parametrize("seed", [0, 3])
def test_apply_channel_matches_jax(seed):
    from sph_tpu.physics import constraints as JC
    inputs = river_inputs(seed)
    js, jp, _ = river_jax(*inputs)
    want = JC.apply_channel(js, jp, jp.dt)
    ts, tp, _ = river_port(*inputs)
    got = TC.apply_channel(ts, tp, tp.dt)
    close(got.pos, want.pos, 2e-5, "pos")
    close(got.vel, want.vel, 1e-5, "vel")
    walled = (got.pos != ts.pos).any(-1)
    assert int(walled.sum()) > 100
    fixed = (ts.ghost > 0) | (ts.valid == 0)
    assert torch.equal(got.vel[fixed], ts.vel[fixed])


# --- the container inside the cell engine's substep -------------------------

SUBSTEP_SCALE = 0.4     # the shapes of HALVES at 0.4x: a few hundred rows


def substep_case(shape, ghosts, device="cpu"):
    """(state, params, config) of the cell engine in ``shape`` at
    ``SUBSTEP_SCALE`` of its half extents, tilted: 400 asked rows pushed
    15% out from the center, so that the container moves some, with random
    velocities; with ``ghosts``, the ghost shell of the effective box
    around it, faces +Y and -Z inactive."""
    half = (np.asarray(HALVES[shape], np.float32)
            * np.float32(SUBSTEP_SCALE))
    euler = ROTATIONS["tilted"]
    spawn = TS.spawn_standard(400, h=0.28, box_half=half, shape_type=shape,
                              seed=3 + shape, box_center=CENTER,
                              box_euler_deg=euler, spawn_rotation="local")
    c = np.asarray(CENTER, np.float32)
    spawn.pos = (c + (spawn.pos - c) * np.float32(1.15)).astype(np.float32)
    spawn.vel = (np.random.default_rng(shape).standard_normal(
        spawn.pos.shape) * 2.0).astype(np.float32)
    if ghosts:
        spawn = TS.concat_spawns(spawn, TS.spawn_ghost_box_shell(
            h=0.28, box_center=CENTER,
            box_half=TP.effective_half_np(shape, half)))
    state = TS.state_from_spawn(spawn, device=device)
    params = TP.FluidParams.default(
        device=device, ghost_face_active=(1, 1, 1, 0, 0, 1),
        **{**params_kw(shape, euler), "box_half": half}).derive_mass()
    dims = TP.compute_grid_dims(shape, half, euler, 0.28)
    return state, params, TP.SimConfig(n=state.n, grid_dims=dims)


def assert_states_equal(got, want):
    for f in dataclasses.fields(want):
        assert torch.equal(getattr(got, f.name), getattr(want, f.name)), \
            f.name


@pytest.mark.parametrize("ghosts", [False, True], ids=["fluid", "ghosts"])
@pytest.mark.parametrize("shape", SHAPES, ids=TP.SHAPE_NAMES)
def test_cell_substep_contains_once_as_reassembly_then_container(shape,
                                                                 ghosts):
    """``engine.step.substep`` on the cell engine applies the container in
    its solve and not again in ``scene_stages``: bit for bit the sweeps'
    reassembly and then ``apply_container``, which moves some rows."""
    state, params, cfg = substep_case(shape, ghosts)
    assert bool((state.ghost > 0).any()) == ghosts
    buf = TSTEP.SceneBuffers.create(cfg, device="cpu")
    aux = TSTEP.neighbor_aux(state, params, params.dt, cfg)
    got, got_buf = TSTEP.substep(state, params, buf, params.dt, cfg, aux=aux)
    solved = sweeps.substep(state, params, params.dt, cfg, aux=aux)
    want = TC.apply_container(solved, params)
    assert_states_equal(got, want)
    assert got_buf == buf
    moved = (want.pos != solved.pos).any(-1)
    assert int(moved.sum()) > 5
    assert not bool(moved[solved.ghost > 0].any())


@pytest.mark.parametrize("call", ["apply_container", "reassemble",
                                  "reassemble_contain"])
def test_container_wrappers_reject_other_devices(call):
    """A device that is neither the CPU nor CUDA raises ``ValueError``."""
    st = TS.ParticleState.zeros(8, device="meta")
    tp = TP.FluidParams.default(device="meta")
    sweep = (st.density, st.pressure, st.pos, st.vel, st.acc)
    run = {"apply_container": lambda: TC.apply_container(st, tp),
           "reassemble": lambda: sweeps.reassemble(st, *sweep, tp),
           "reassemble_contain": lambda: sweeps.reassemble(
               st, *sweep, tp, ghosts=True, contain=True)}[call]
    with pytest.raises(ValueError, match="meta"):
        run()


@pytest.mark.parametrize("path", ["apply_container", "reassemble",
                                  "run_substeps"])
def test_container_launches_stay_zero_on_cpu(path):
    """``launches.container`` is in ``trace.counters()`` and counts no
    launch on the CPU, where the plain versions run."""
    TC.reset_launches()
    state, params, cfg = substep_case(TP.SHAPE_BOX, True)
    if path == "apply_container":
        out = TC.apply_container(state, params)
    elif path == "reassemble":
        out = sweeps.reassemble(state, state.density, state.pressure,
                                state.pos, state.vel, state.acc, params,
                                ghosts=True, contain=True)
    else:
        out, _ = TSTEP.run_substeps(
            state, params, TSTEP.SceneBuffers.create(cfg, device="cpu"),
            params.dt, 2, cfg)
    assert out.pos.device.type == "cpu"
    assert trace.counters()["launches.container"] == 0


# --- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rotation", list(ROTATIONS))
@pytest.mark.parametrize("shape", SHAPES, ids=TP.SHAPE_NAMES)
def test_constraints_on_cuda_match_cpu(cuda, shape, rotation):
    """``apply_container`` of every shape under both rotations (the
    container kernel, one launch), and the terrain and the channel, on CUDA
    tensors against the CPU."""
    d = scattered(shape, ROTATIONS[rotation])
    TC.reset_launches()
    out = {}
    for dev in (cuda, "cpu"):
        out[str(dev)] = TC.apply_container(
            state_from_numpy(d, device=dev),
            port_params(shape, ROTATIONS[rotation], device=dev))
        torch.cuda.synchronize()
    assert TC.LAUNCHES == {"container": 1}
    assert out["cuda"].pos.device.type == "cuda"
    close(out["cuda"].pos.cpu(), out["cpu"].pos, 1e-5, "pos")
    close(out["cuda"].vel.cpu(), out["cpu"].vel, 1e-4, "vel")
    inputs = river_inputs()
    river = {}
    for dev in (cuda, "cpu"):
        ts, tp, tt = river_port(*inputs, device=dev)
        river[str(dev)] = TC.apply_channel(TC.apply_terrain(ts, tt, tp), tp,
                                           tp.dt)
    close(river["cuda"].pos.cpu(), river["cpu"].pos, 1e-5, "river pos")
    close(river["cuda"].vel.cpu(), river["cpu"].vel, 1e-4, "river vel")


@pytest.mark.cuda
@pytest.mark.parametrize("ghosts", [False, True], ids=["fluid", "ghosts"])
@pytest.mark.parametrize("rotation", list(ROTATIONS))
@pytest.mark.parametrize("shape", SHAPES, ids=TP.SHAPE_NAMES)
def test_cell_substep_with_container_on_cuda_matches_cpu(cuda, shape,
                                                         rotation, ghosts):
    """The cell engine's substep, whose reassembly and container are one
    launch of the container kernel on the card, against the plain versions
    on the CPU, for every shape under both rotations, within the sweep
    kernels' tolerances (``tests/test_torch_sweeps.py``)."""
    euler = ROTATIONS[rotation]
    TC.reset_launches()
    out = {}
    for dev in (cuda, "cpu"):
        state, params, cfg = substep_case(shape, ghosts, device=dev)
        params = params.replace(box_euler_deg=torch.as_tensor(
            np.asarray(euler, np.float32), device=dev))
        st, _ = TSTEP.substep(state, params,
                              TSTEP.SceneBuffers.create(cfg, device=dev),
                              params.dt, cfg)
        torch.cuda.synchronize()
        order = torch.argsort(st.orig_id)
        out[str(dev)] = {f: getattr(st, f)[order].cpu()
                         for f in ("pos", "vel", "density", "foam")}
    assert TC.LAUNCHES == {"container": 1}
    got, want = out["cuda"], out["cpu"]
    close(got["pos"], want["pos"], 1e-5, "pos")
    close(got["vel"], want["vel"], 1e-3, "vel")
    torch.testing.assert_close(got["density"], want["density"], rtol=1e-5,
                               atol=1e-2)
    close(got["foam"], want["foam"], 1e-4, "foam")


@pytest.mark.cuda
def test_container_pass_checks_inputs_on_cuda(cuda):
    """The container pass's wrapper raises ``ValueError`` on what its
    kernel does not take, before it launches."""
    d = scattered(TP.SHAPE_BOX, ROTATIONS["upright"])
    st = state_from_numpy(d, device=cuda)
    tp = port_params(TP.SHAPE_BOX, device=cuda)
    TC.reset_launches()
    bad = {"rows apart": st.replace(pos=st.pos.t().contiguous().t()),
           "dtype": st.replace(vel=st.vel.double()),
           "shape": st.replace(valid=st.valid[:-1]),
           "device": st.replace(ghost=st.ghost.cpu())}
    for name, s in bad.items():
        with pytest.raises(ValueError):
            TC.apply_container(s, tp)
    with pytest.raises(ValueError, match="box_half"):
        TC.apply_container(st, tp.replace(box_half=tp.box_half.double()))
    torch.cuda.synchronize()
    assert TC.LAUNCHES == {"container": 0}
