"""River and fountain modes (sph_tpu_torch.engine.step with
sph_tpu_torch.physics.emitters, constraints' terrain and channel) against
``sph_tpu``: 20 substeps of each mode on a 2,048-row spawn in the box of
half 7, JAX ``brute`` against the port's ``brute`` and ``cell`` (plain on
the CPU), with the rows the emitters respawned counted on both sides.

CUDA (marker ``cuda``, skipped without a card): 20 substeps of each mode
through the cell engine's kernels against its plain versions, from inputs
that the port builds itself (``port_case``), so that they run where JAX
is not installed:

    python -m pytest tests/test_torch_modes.py -q -m cuda --noconftest

The JAX reference densities of the scene paths that ``chip_smoke.py``
drives (the constants in its ``REF_RHO``) are printed by

    PYTHONPATH=. python tests/test_torch_modes.py <path> [frames] [capacity] [engine]

(``river_65k``, ``torus_vortex_50k`` or ``fountain_50k``; 4 frames,
capacity 16 and ``binned`` by default): ``sph_tpu`` on the CPU, each frame
as ``sph_tpu/scene/scene.py:176-226`` runs it, with the fullest cell that
any substep binned, which must not pass the capacity (``binned`` gives the
rows past it a gravity-only update).  The references: ``torus_vortex_50k
4 16``, ``fountain_50k 4 32`` and ``river_65k 4 16 brute`` (whose start
piles up to 693 rows in a cell).
"""
import dataclasses
import sys

import numpy as np
import pytest
import torch

# tests/test_brute_pallas.py:40-42
POS_TOL, VEL_TOL, RHO_TOL = 1e-4, 1e-3, 1.0
N_SUB = 20
# The fixtures of the two modes, 2,048 rows in the box of half 7.  River
# mode starts from the reference's channel spawner (``spawn_river``,
# SPHFluid3D.cpp:104-158) without its jitter, with its first row across
# the channel (z within half a lattice step of -6.76) moved 13.5
# downstream, past the sink at z 6.5, so that the stream stage respawns it
# in the first substep.  The jitter would move rows of the canyon's steep
# walls into the terrain (the spawner samples the height at the lattice
# point), where from the first substep they rest on it and the terrain
# stage's below/into tests decide on a rounding error: moving every row
# by 2e-7 then changes velocities by 4e-3 within 4 substeps, against
# 2.7e-4 over 20 without the jitter, where the terrain still lifts about
# 125 rows in a run.  The box's dam column is no fixture for river mode:
# most of it starts inside the terrain, which lifts it into one sheet
# whose compression amplifies rounding tenfold a substep, so that after
# 20 substeps JAX's own "brute" and "cell" engines differ by 11.8 in
# position (ROADMAP R12).  The
# fountain's drain plane moves from 1.0 above the floor to DRAIN_LEVEL,
# halfway between the box spawn's layers 2 and 3 (spacing 0.238, jitter
# 0.048): a row that crossed it by less than a rounding error would be
# recycled by one engine and not by another; its drain rate rises to
# DRAIN_PER_SEC (its default, 2 per second, gives a chance of 0.002 a
# substep).
PAST_SINK_DZ = 13.5
DRAIN_LEVEL = 0.238 * 3.5
DRAIN_PER_SEC = 50.0


def first_row_past_the_sink(spawn):
    """``spawn`` (a river spawn) with its first row across the channel
    moved PAST_SINK_DZ downstream."""
    first = spawn.pos[:, 2] < -7.0 + 0.238 * 1.5
    spawn.pos[first, 2] += np.float32(PAST_SINK_DZ)
    return spawn
MODES = ("river", "fountain")


def to_numpy(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def jax_case(mode):
    """(state, params, config, buffers) of the JAX package: 2,048 rows in
    the box of half 7, in river mode as ``Scene.enable_river(0)`` sets it
    up (``sph_tpu/scene/scene.py:261-276``) or with the fountain on."""
    import jax.numpy as jnp
    from sph_tpu.core import params as JP
    from sph_tpu.core import state as JS
    from sph_tpu.engine import step as JSTEP
    from sph_tpu.scene import river as JR

    params = JP.FluidParams.default().derive_mass()
    center, half = (0.0, 0.0, 0.0), (7.0, 7.0, 7.0)
    dims = JP.compute_grid_dims(0, np.asarray(half, np.float32),
                                np.zeros(3, np.float32), 0.28)
    if mode == "river":
        spec = JR.RiverSpec.random(0)
        terrain = JR.generate_river_terrain(spec, center, half)
        params = JR.river_params(params, spec, center, half)
        spawn = first_row_past_the_sink(JS.spawn_river(
            2048, terrain, box_center=center, box_half=half,
            river_amp=spec.amp, river_freq=spec.freq, river_phase=spec.phase,
            river_channel_width=spec.channel_width,
            river_emitter_pos=tuple(np.asarray(params.river_emitter_pos)),
            use_jitter=False))
    else:
        params = params.replace(
            fountain_drain_per_sec=jnp.float32(DRAIN_PER_SEC),
            fountain_drain_level=jnp.float32(DRAIN_LEVEL))
        spawn = JS.spawn_standard(2048, seed=7)
    state = JS.state_from_spawn(spawn)
    cfg = JP.SimConfig(n=state.n, grid_dims=dims, neighbor_impl="brute",
                       river_mode=mode == "river",
                       fountain_mode=mode == "fountain")
    buf = JSTEP.SceneBuffers.create(cfg)
    if mode == "river":
        buf = buf.replace(terrain=jnp.asarray(terrain))
    return state, params, cfg, buf


def port_case(mode, device):
    """``jax_case`` built with the port's own code (its spawn and terrain
    are the JAX package's, bit for bit) on ``device``: (state, params,
    config, buffers), with no JAX."""
    from sph_tpu_torch.core import params as TP
    from sph_tpu_torch.core import state as TS
    from sph_tpu_torch.engine import step as TSTEP
    from sph_tpu_torch.scene import river as TR

    params = TP.FluidParams.default(device=device).derive_mass()
    center, half = (0.0, 0.0, 0.0), (7.0, 7.0, 7.0)
    dims = TP.compute_grid_dims(0, np.asarray(half, np.float32),
                                np.zeros(3, np.float32), 0.28)
    if mode == "river":
        spec = TR.RiverSpec.random(0)
        terrain = TR.generate_river_terrain(spec, center, half)
        params = TR.river_params(params, spec, center, half)
        spawn = first_row_past_the_sink(TS.spawn_river(
            2048, terrain, box_center=center, box_half=half,
            river_amp=spec.amp, river_freq=spec.freq, river_phase=spec.phase,
            river_channel_width=spec.channel_width,
            river_emitter_pos=tuple(params.river_emitter_pos.tolist()),
            use_jitter=False))
    else:
        params = params.replace(
            fountain_drain_per_sec=torch.tensor(DRAIN_PER_SEC, device=device),
            fountain_drain_level=torch.tensor(DRAIN_LEVEL, device=device))
        spawn = TS.spawn_standard(2048, seed=7)
    state = TS.state_from_spawn(spawn, device=device)
    cfg = TP.SimConfig(n=state.n, grid_dims=dims, river_mode=mode == "river",
                       fountain_mode=mode == "fountain")
    buf = TSTEP.SceneBuffers.create(cfg, device=device)
    if mode == "river":
        buf = buf.replace(terrain=torch.as_tensor(terrain, device=device))
    return state, params, cfg, buf


def jax_run_counted(state, params, cfg, buf, n_sub):
    """JAX ``run_substeps`` one substep a call, ``n_sub`` calls, with the
    rows respawned in each counted: an emitter's last stage leaves its rows
    at acc 0, which the solve never leaves a fluid row at."""
    import jax.numpy as jnp
    from sph_tpu.engine import step as JSTEP

    total = 0
    for _ in range(n_sub):
        state, buf = JSTEP.run_substeps(state, params, buf, params.dt, 1, cfg)
        fluid = (state.valid > 0) & (state.ghost == 0)
        total += int(jnp.sum(fluid & jnp.all(state.acc == 0.0, axis=-1)))
    return state, total


@pytest.fixture(scope="module")
def mode_runs():
    """Per mode: the start (numpy), JAX ``run_substeps`` (``brute``) after
    20 substeps with its count of respawned rows, and the port's ``brute``
    and ``cell`` runs with their final buffers (which count them)."""
    from sph_tpu_torch.core.convert import (buffers_from_numpy,
                                            params_from_numpy,
                                            state_from_numpy)
    from sph_tpu_torch.core.params import SimConfig
    from sph_tpu_torch.engine import step as TSTEP

    out = {}
    for mode in MODES:
        js, jp, jcfg, jbuf = jax_case(mode)
        ref, jcount = jax_run_counted(js, jp, jcfg, jbuf, N_SUB)
        runs = {}
        for impl in ("brute", "cell"):
            ts = state_from_numpy(to_numpy(js), device="cpu")
            tp = params_from_numpy(to_numpy(jp), device="cpu")
            tb = buffers_from_numpy(to_numpy(jbuf), device="cpu")
            cfg = SimConfig(n=ts.n, grid_dims=jcfg.grid_dims,
                            neighbor_impl=impl, river_mode=jcfg.river_mode,
                            fountain_mode=jcfg.fountain_mode)
            st, buf = TSTEP.run_substeps(ts, tp, tb, tp.dt, N_SUB, cfg)
            runs[impl] = (to_numpy(st), buf)
        out[mode] = dict(start=to_numpy(js), ref=to_numpy(ref),
                         jcount=jcount, runs=runs, params=jp)
    return out


def realigned_errors(ref, got):
    ia = np.argsort(ref["orig_id"], kind="stable")
    ib = np.argsort(got["orig_id"], kind="stable")
    v = (ref["valid"][ia] > 0) & (ref["ghost"][ia] == 0)
    return {f: float(np.abs(ref[f][ia][v] - got[f][ib][v]).max())
            for f in ("pos", "vel", "density")}


@pytest.mark.parametrize("impl", ["brute", "cell"])
@pytest.mark.parametrize("mode", MODES)
def test_mode_matches_jax_brute(mode_runs, mode, impl):
    r = mode_runs[mode]
    got, buf = r["runs"][impl]
    err = realigned_errors(r["ref"], got)
    assert err["pos"] < POS_TOL, err
    assert err["vel"] < VEL_TOL, err
    assert err["density"] < RHO_TOL, err
    # the emitters respawned as many rows as JAX's, and some
    assert int(buf.recycled) == r["jcount"] > 0
    assert int(buf.fountain_seed) == (N_SUB if mode == "fountain" else 0)


def test_river_rows_stay_in_the_channel(mode_runs):
    """After the river's last stage (``stream_emit``) no fluid row is below
    the sink or past it, and every row is inside the box and the
    channel's walls."""
    r = mode_runs["river"]
    p = r["params"]
    for impl in ("brute", "cell"):
        got, _ = r["runs"][impl]
        v = (got["valid"] > 0) & (got["ghost"] == 0)
        pos = got["pos"][v]
        assert (pos[:, 1] >= float(p.river_sink_y)).all()
        assert (pos[:, 2] <= float(p.river_sink_z_max)).all()
        assert (np.abs(pos) <= 7.0 + 1e-4).all()
        cx = float(p.river_amp) * np.sin(float(p.river_freq) * pos[:, 2]
                                         + float(p.river_phase))
        assert (np.abs(pos[:, 0] - cx)
                <= float(p.river_channel_width) + 1e-4).all()


def test_fountain_recycles_into_the_jet(mode_runs):
    """The rows that the fountain recycled in the last substep (acc 0 and
    rho0, which the solve never leaves) sit on the nozzle disc and move
    up at the jet's speed."""
    r = mode_runs["fountain"]
    p = r["params"]
    got, _ = r["runs"]["cell"]
    v = (got["valid"] > 0) & (got["ghost"] == 0)
    new = v & (got["acc"] == 0).all(axis=-1) & (got["density"] == 1000.0)
    assert 0 < new.sum() < v.sum() // 10
    emit = np.asarray(p.box_center) + np.asarray(p.fountain_offset)
    rel = got["pos"][new] - emit
    assert (np.hypot(rel[:, 0], rel[:, 2])
            <= float(p.fountain_radius) + 1e-5).all()
    assert ((rel[:, 1] >= 0) & (rel[:, 1] <= 0.2 + 1e-5)).all()
    speed = np.linalg.norm(got["vel"][new], axis=-1)
    np.testing.assert_allclose(speed, float(p.fountain_jet_speed), rtol=1e-5)
    assert (got["vel"][new][:, 1] > 0).all()


def test_mode_precedence_river_over_fountain():
    """With both flags the substep runs the river's stages and not the
    fountain's (``sph_tpu/engine/step.py:92``)."""
    from sph_tpu_torch.core.convert import (buffers_from_numpy,
                                            params_from_numpy,
                                            state_from_numpy)
    from sph_tpu_torch.core.params import SimConfig
    from sph_tpu_torch.engine import step as TSTEP

    js, jp, jcfg, jbuf = jax_case("river")
    ts = state_from_numpy(to_numpy(js), device="cpu")
    tp = params_from_numpy(to_numpy(jp), device="cpu")
    tb = buffers_from_numpy(to_numpy(jbuf), device="cpu")
    cfg = SimConfig(n=ts.n, grid_dims=jcfg.grid_dims, neighbor_impl="brute",
                    river_mode=True)
    river, rbuf = TSTEP.substep(ts, tp, tb, tp.dt, cfg)
    both, bbuf = TSTEP.substep(ts, tp, tb, tp.dt, dataclasses.replace(
        cfg, fountain_mode=True))
    for f in ("pos", "vel", "density"):
        assert torch.equal(getattr(river, f), getattr(both, f)), f
    assert int(bbuf.fountain_seed) == 0
    assert int(bbuf.recycled) == int(rbuf.recycled) > 0


def test_port_case_is_jax_case():
    """The port-only inputs of the CUDA test are the JAX fixture's, bit for
    bit."""
    from sph_tpu_torch.core.params import SimConfig
    for mode in MODES:
        js, jp, jcfg, jbuf = jax_case(mode)
        ts, tp, cfg, tb = port_case(mode, "cpu")
        for obj, ref in ((ts, js), (tp, jp), (tb, jbuf)):
            want = to_numpy(ref)
            for f, v in want.items():
                got = getattr(obj, f)
                got = np.asarray(got.numpy() if torch.is_tensor(got) else got)
                np.testing.assert_array_equal(got, v.astype(got.dtype),
                                              err_msg=f)
        assert cfg == SimConfig(n=jcfg.n, grid_dims=jcfg.grid_dims,
                                river_mode=jcfg.river_mode,
                                fountain_mode=jcfg.fountain_mode)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell engine's kernels have no "
                    "CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_mode_on_cuda_matches_cpu(cuda, mode):
    """20 substeps of each mode through the cell engine's kernels on the
    card against its plain versions on the CPU, realigned by orig_id,
    with equal counts of respawned rows."""
    from sph_tpu_torch.engine import step as TSTEP
    from sph_tpu_torch.neighbors import cells, sweeps

    outs = {}
    for dev in ("cpu", cuda):
        ts, tp, cfg, tb = port_case(mode, dev)
        sweeps.reset_launches()
        cells.reset_launches()
        st, buf = TSTEP.run_substeps(ts, tp, tb, tp.dt, N_SUB, cfg)
        outs[str(dev)] = ({f: getattr(st, f).cpu().numpy() for f in (
            "pos", "vel", "density", "valid", "ghost", "orig_id")},
            int(buf.recycled))
    assert sweeps.LAUNCHES["density"] == N_SUB
    assert cells.LAUNCHES["cell_table"] == N_SUB
    (ref, n_ref), (got, n_got) = outs["cpu"], outs["cuda"]
    err = realigned_errors(ref, got)
    assert err["pos"] < POS_TOL and err["vel"] < VEL_TOL, err
    assert err["density"] < RHO_TOL, err
    assert n_got == n_ref > 0


# ---------------------------------------------------------------------------
# the JAX reference densities of chip_smoke.py's scene paths
# ---------------------------------------------------------------------------

def jax_scene_build(name, engine="binned", capacity=16, seed=0, count=None):
    """(settings, state, params, config, buffers) of the scene path ``name``
    in the JAX package: the spawn of ``Scene.respawn``, and for the river
    ``Scene.enable_river(seed)``, as ``app/scene_paths.build`` does in the
    port (``count`` overrides the path's particle count)."""
    import jax.numpy as jnp
    from sph_tpu.core import params as JP
    from sph_tpu.core import state as JS
    from sph_tpu.engine import step as JSTEP
    from sph_tpu.scene import art_presets as JAP
    from sph_tpu.scene import river as JRV
    from sph_tpu.scene.scene import params_from_settings
    from sph_tpu.scene.settings import SceneSettings
    from sph_tpu_torch.app.scene_paths import PATHS

    n, art, river, fountain = PATHS[name]
    s = SceneSettings()
    s.particle_count = n if count is None else count
    if art is not None:
        s = JAP.apply_art_preset(s, art)
    s.fountain_on = fountain
    s.audio_enabled = True
    aux = tuple(s.shape_aux) if any(s.shape_aux) else (5.0, 0.35, 2.5)
    spawn = JS.spawn_standard(
        s.particle_count, h=s.h, rest_density=s.rest_density,
        box_center=tuple(s.box_center), box_half=tuple(s.box_half),
        shape_type=s.shape_type, shape_aux=aux, mix_pattern=s.mix_pattern,
        use_jitter=s.use_jitter, jitter_amp=s.jitter_amp, seed=seed,
        box_euler_deg=tuple(s.box_euler))
    state = JS.state_from_spawn(spawn)
    params = params_from_settings(s)
    dims = JP.compute_grid_dims(s.shape_type,
                                np.asarray(s.box_half, np.float32),
                                np.asarray(s.box_euler, np.float32), s.h)
    cfg = JP.SimConfig(n=state.n, grid_dims=dims, neighbor_impl=engine,
                       cell_capacity=capacity, fountain_mode=s.fountain_on)
    buf = JSTEP.SceneBuffers.create(cfg)
    if river:
        spec = JRV.RiverSpec.random(seed)
        terrain = JRV.generate_river_terrain(spec, s.box_center, s.box_half,
                                             res=cfg.terrain_res)
        params = JRV.river_params(params, spec, s.box_center, s.box_half)
        cfg = dataclasses.replace(cfg, river_mode=True)
        buf = buf.replace(terrain=jnp.asarray(terrain))
    return s, state, params, cfg, buf


def jax_scene_frames(name, frames, engine="binned", capacity=16, seed=0,
                     count=None, substeps=None):
    """Yield (frame, substeps done, state, fullest cell so far) after each
    frame of the scene path ``name`` in the JAX package, each frame as
    ``Scene.update`` runs it (continuous wave, audio reaction, the jet
    speed from the live values, the substep accumulator), one substep a
    ``run_substeps`` call; with ``substeps``, only the first that many of
    each frame's substeps."""
    import jax
    import jax.numpy as jnp
    from sph_tpu.engine import step as JSTEP
    from sph_tpu.neighbors import binned as JB
    from sph_tpu.scene import reaction as JR
    from sph_tpu.scene.scene import MAX_SUBSTEPS_PER_FRAME
    from sph_tpu_torch.app.scene_paths import FRAME_DT, bands

    s, state, params, cfg, buf = jax_scene_build(name, engine, capacity,
                                                 seed, count)
    keys = jax.jit(lambda st: JB.compute_keys(st, params, cfg.grid_dims))
    phases, acc, worst, done = JR.ReactionPhases(), 0.0, 0, 0
    for frame in range(frames):
        state, phases = JR.drive_continuous_wave(state, s, phases, FRAME_DT)
        state, params, phases, live = JR.drive_audio_reaction(
            state, params, s, phases, *bands(frame), FRAME_DT)
        params = params.replace(
            fountain_jet_speed=jnp.float32(live.fountain_jet))
        n_sub, acc = JSTEP.substeps_for_frame(
            FRAME_DT, s.time_step, MAX_SUBSTEPS_PER_FRAME, acc)
        if substeps is not None:
            n_sub = min(n_sub, substeps)
        for _ in range(n_sub):
            occ = np.bincount(np.asarray(keys(state)),
                              minlength=cfg.num_cells + 1)[:cfg.num_cells]
            worst = max(worst, int(occ.max()))
            state, buf = JSTEP.run_substeps(state, params, buf,
                                            jnp.float32(s.time_step), 1, cfg)
        done += n_sub
        yield frame, done, state, worst


@pytest.mark.parametrize("name", ["river_65k", "torus_vortex_50k",
                                  "fountain_50k"])
def test_scene_path_builds_as_the_jax_scene(name):
    """``app/scene_paths.build`` at 1,500 asked rows is the JAX package's
    scene, bit for bit: settings, state, params and buffers."""
    from sph_tpu_torch.app import scene_paths
    js, jst, jp, jcfg, jbuf = jax_scene_build(name, count=1500)
    s, st, p, cfg, buf = scene_paths.build(name, count=1500, device="cpu")
    assert dataclasses.asdict(s) == dataclasses.asdict(js)
    for obj, ref in ((st, jst), (p, jp), (buf, jbuf)):
        for f, v in to_numpy(ref).items():
            got = getattr(obj, f)
            got = np.asarray(got.numpy() if torch.is_tensor(got) else got)
            np.testing.assert_array_equal(got, v.astype(got.dtype),
                                          err_msg=f)
    assert (cfg.grid_dims, cfg.river_mode, cfg.fountain_mode) == (
        jcfg.grid_dims, jcfg.river_mode, jcfg.fountain_mode)


# The river as users start it (the box spawn, whose lower layers the
# terrain lifts into one sheet in the first substep) is held over its first
# substep only: at 1,500 asked rows the port's cell engine and JAX "brute"
# differ by 3.0e-6 in velocity after one substep and by 0.62 after two, as
# rows that rest on the terrain take its lift or not on a rounding error
# (ROADMAP R12).  The other paths are held over their whole first frame.
FRAME_CHECK_SUBSTEPS = {"river_65k": 1}


@pytest.mark.parametrize("name", ["river_65k", "torus_vortex_50k",
                                  "fountain_50k"])
def test_scene_path_frame_matches_jax(name):
    """The first frame of the path at 1,500 asked rows (the audio
    reaction, then the vortex, the fountain or the river's stages; 16
    substeps, the river's first only): the port's cell engine (plain)
    against JAX ``brute``, realigned by orig_id."""
    from sph_tpu_torch.app import scene_paths
    from sph_tpu_torch.engine.step import run_substeps
    from sph_tpu_torch.scene.reaction import ReactionPhases
    k = FRAME_CHECK_SUBSTEPS.get(name, 16)
    (_, done, ref, _), = jax_scene_frames(name, 1, engine="brute",
                                          count=1500, substeps=k)
    s, st, p, cfg, buf = scene_paths.build(name, count=1500, device="cpu")
    if k == 16:
        st, p, buf, _, _, n_sub = scene_paths.frame(0, st, p, buf, cfg, s,
                                                    ReactionPhases(), 0.0)
    else:
        st, p, _, _, n_sub, dt = scene_paths.frame_start(
            0, st, p, s, ReactionPhases(), 0.0)
        assert n_sub == 16
        st, buf = run_substeps(st, p, buf, dt, k, cfg)
        n_sub = k
    assert n_sub == done == k
    err = realigned_errors(to_numpy(ref), to_numpy(st))
    assert err["pos"] < POS_TOL, err
    assert err["vel"] < VEL_TOL, err
    assert err["density"] < RHO_TOL, err


def jax_scene_reference(name: str, frames: int = 4, capacity: int = 16,
                        engine: str = "binned", seed: int = 0):
    """Yield (frame, substeps done, fluid rows, fluid density max, mean,
    fullest cell so far) after each frame of ``jax_scene_frames``."""
    for frame, done, state, worst in jax_scene_frames(name, frames, engine,
                                                      capacity, seed):
        fluid = (np.asarray(state.valid) > 0) & (np.asarray(state.ghost) == 0)
        rho = np.asarray(state.density)[fluid]
        yield (frame, done, int(fluid.sum()), float(rho.max()),
               float(rho.astype(np.float64).mean()), worst)


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    name = sys.argv[1]
    frames = int(sys.argv[2]) if len(sys.argv) > 2 else 4
    cap = int(sys.argv[3]) if len(sys.argv) > 3 else 16
    engine = sys.argv[4] if len(sys.argv) > 4 else "binned"
    for frame, done, n, rho_max, rho_mean, worst in jax_scene_reference(
            name, frames, cap, engine):
        print(f"{name} frame {frame} substep {done}: {n} fluid rows, fluid "
              f"density max {rho_max!r} mean {rho_mean!r}; fullest cell "
              f"{worst} rows (capacity {cap})", flush=True)
