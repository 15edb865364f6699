"""The frame as one program (``sph_tpu_torch/engine/graph.py``, the
counterpart of ``sph_tpu/engine/step.py``'s ``_run_substeps_jit``) and
the host waits that stood in its way.

On the CPU ``run_substeps`` is the eager loop, ``run_substeps_eager``:
over 2 frames of 8 substeps it is bit-equal to it and within the engine
tolerances of JAX ``run_substeps`` (``brute``, the oracle) for the cell
engine with ghosts, the fountain and the all-pairs kernels' plain path.
The cell keys are bit-equal to JAX's with rows outside the grid on every
side, the sweep constants' device block holds ``make_pvec``'s float32
values bit for bit, and the wave's tensors built once give the wave of
host floats.

CUDA (marker ``cuda``, skipped without a card): the captured program
against the eager loop, bit-identical by ``orig_id``, over 2 frames of
each engine; a gravity change between frames; a change of the substep
count; the launch counts after replays; a capture that fails raises.
Their inputs are built with the port alone:

    python -m pytest tests/test_torch_graph.py -q -m cuda --noconftest
"""
import ast
import dataclasses
import os

import numpy as np
import pytest
import torch

from sph_tpu_torch.core import params as TP
from sph_tpu_torch.core import state as TS
from sph_tpu_torch.core.convert import to_numpy
from sph_tpu_torch.engine import graph
from sph_tpu_torch.engine import step as TSTEP
from sph_tpu_torch.neighbors import cells, sweeps
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


# tests/test_brute_pallas.py:40-42
POS_TOL, VEL_TOL, RHO_TOL = 1e-4, 1e-3, 1.0
FRAMES, N_SUB = 2, 8
# the fountain's drain plane between the box spawn's layers 2 and 3 and a
# drain rate that recycles rows every substep (tests/test_torch_modes.py)
DRAIN_LEVEL = 0.238 * 3.5
DRAIN_PER_SEC = 50.0
CASES = ("ghosts", "fountain", "brute_kernel")
CUDA_CASES = CASES + ("brute", "emit_rows", "river")


def port_case(case, device):
    """(state, params, config, buffers) of ``case``, built by the port on
    ``device``: 512 fluid rows in a box of half 3 inside a ghost shell
    (cell engine), 1,024 rows of the fountain in the box of half 7 (cell
    engine), a 1,024-row dam break on the all-pairs kernels or the oracle,
    the dam break with the emitted-row transport, or 1,024 rows of the
    river over its terrain."""
    from sph_tpu_torch.scene import river as TR

    impl = {"brute_kernel": "brute_kernel", "brute": "brute"}.get(case,
                                                                 "cell")
    half = (3.0, 3.0, 3.0) if case == "ghosts" else (7.0, 7.0, 7.0)
    params = TP.FluidParams.default(
        device=device, box_half=np.asarray(half, np.float32)).derive_mass()
    dims = TP.compute_grid_dims(0, np.asarray(half, np.float32),
                                np.zeros(3, np.float32), 0.28)
    terrain = None
    if case == "ghosts":
        fluid = TS.spawn_standard(512, h=0.28, box_half=half, seed=1)
        fluid.pos += np.asarray([-0.35, -0.2, -0.35], np.float32)
        spawn = TS.concat_spawns(
            fluid, TS.spawn_ghost_box_shell(h=0.28, box_half=half))
    elif case == "river":
        spec = TR.RiverSpec.random(0)
        terrain = TR.generate_river_terrain(spec, (0.0, 0.0, 0.0), half)
        params = TR.river_params(params, spec, (0.0, 0.0, 0.0), half)
        spawn = TS.spawn_river(
            1024, terrain, box_half=half, river_amp=spec.amp,
            river_freq=spec.freq, river_phase=spec.phase,
            river_channel_width=spec.channel_width,
            river_emitter_pos=tuple(params.river_emitter_pos.tolist()),
            use_jitter=False)
    else:
        spawn = TS.spawn_standard(1024, seed=7)
    if case == "fountain":
        params = params.replace(
            fountain_drain_per_sec=torch.tensor(DRAIN_PER_SEC, device=device),
            fountain_drain_level=torch.tensor(DRAIN_LEVEL, device=device))
    state = TS.state_from_spawn(spawn, device=device)
    cfg = TP.SimConfig(n=state.n, grid_dims=dims, neighbor_impl=impl,
                       fountain_mode=case == "fountain",
                       river_mode=case == "river",
                       emit_rows=case == "emit_rows")
    buf = TSTEP.SceneBuffers.create(cfg, device=device)
    if terrain is not None:
        buf = buf.replace(terrain=torch.as_tensor(terrain, device=device))
    return state, params, cfg, buf


def frames(run, state, params, cfg, buf, n_frames=FRAMES, n_sub=N_SUB):
    for _ in range(n_frames):
        state, buf = run(state, params, buf, params.dt, n_sub, cfg)
    return state, buf


def by_orig_id(state):
    order = torch.argsort(state.orig_id.cpu())
    return {f.name: getattr(state, f.name).cpu()[order]
            for f in dataclasses.fields(state)}


def assert_bit_identical(got, want):
    (gs, gb), (ws, wb) = got, want
    g, w = by_orig_id(gs), by_orig_id(ws)
    for name in g:
        assert torch.equal(g[name], w[name]), name
    for f in dataclasses.fields(gb):
        assert torch.equal(getattr(gb, f.name), getattr(wb, f.name)), f.name


# ---------------------------------------------------------------------------
# the CPU: the eager loop, against JAX
# ---------------------------------------------------------------------------

def jax_frames(state, params, cfg, buf):
    """JAX ``run_substeps`` (``brute``) over the same frames, from the
    port's inputs carried across as numpy."""
    import jax.numpy as jnp
    from sph_tpu.core.params import FluidParams as JFP
    from sph_tpu.core.params import SimConfig as JSC
    from sph_tpu.core.state import ParticleState as JPS
    from sph_tpu.engine import step as JSTEP

    js = JPS(**{k: jnp.asarray(v) for k, v in to_numpy(state).items()})
    pd = to_numpy(params)
    jp = JFP(shape_type=int(pd.pop("shape_type")),
             **{k: jnp.asarray(v) for k, v in pd.items()})
    jcfg = JSC(n=cfg.n, grid_dims=cfg.grid_dims, neighbor_impl="brute",
               fountain_mode=cfg.fountain_mode, river_mode=cfg.river_mode)
    jbuf = JSTEP.SceneBuffers.create(jcfg)
    for _ in range(FRAMES):
        js, jbuf = JSTEP.run_substeps(js, jp, jbuf, jp.dt, N_SUB, jcfg)
    return {k: np.asarray(v) for k, v in to_numpy(js).items()}


@pytest.mark.parametrize("case", CASES)
def test_run_substeps_is_the_eager_loop_and_matches_jax(case):
    state, params, cfg, buf = port_case(case, "cpu")
    captures = trace.counter("graph.captures")
    got = frames(TSTEP.run_substeps, state, params, cfg, buf)
    assert trace.counter("graph.captures") == captures
    assert_bit_identical(got, frames(TSTEP.run_substeps_eager, state, params,
                                     cfg, buf))
    want = jax_frames(state, params, cfg, buf)
    g = by_orig_id(got[0])
    order = np.argsort(want["orig_id"], kind="stable")
    fluid = ((want["valid"] > 0) & (want["ghost"] == 0))[order]
    assert fluid.sum() > 0
    for name, tol in (("pos", POS_TOL), ("vel", VEL_TOL),
                      ("density", RHO_TOL)):
        err = np.abs(g[name].numpy()[fluid] - want[name][order][fluid]).max()
        assert err < tol, (name, err)
    np.testing.assert_array_equal(g["orig_id"].numpy(),
                                  want["orig_id"][order])


def test_grid_cell_coords_and_keys_bit_equal_jax_at_every_clamp():
    """Rows inside a rotated box and past each face of its grid: the
    coordinates clamp with the grid's dims on the device (no host copy)
    and equal JAX's, and so do the keys."""
    import jax.numpy as jnp
    from sph_tpu.core import params as JP
    from sph_tpu.neighbors import planes as PL

    half, euler = (4.0, 3.0, 3.5), (20.0, 0.0, 30.0)
    rng = np.random.default_rng(3)
    pos = rng.uniform(-9.0, 9.0, (2000, 3)).astype(np.float32)
    tp = TP.FluidParams.default(device="cpu",
                                box_half=np.asarray(half, np.float32),
                                box_euler_deg=np.asarray(euler, np.float32))
    jp = JP.FluidParams.default(box_half=np.asarray(half, np.float32),
                                box_euler_deg=np.asarray(euler, np.float32))
    dims = TP.compute_grid_dims(0, half, euler, 0.28)
    got = TP.grid_cell_coords(torch.as_tensor(pos), tp, dims).numpy()
    want = np.asarray(JP.grid_cell_coords(jnp.asarray(pos), jp, dims))
    np.testing.assert_array_equal(got, want)
    for axis, d in enumerate(dims):        # every clamp is reached
        assert (got[:, axis] == 0).any() and (got[:, axis] == d - 1).any()
    mask = rng.uniform(size=2000) < 0.9
    geom = PL.geom_for(JP.SimConfig(n=2000, grid_dims=dims))
    np.testing.assert_array_equal(
        cells.compute_keys_ymajor(torch.as_tensor(pos),
                                  torch.as_tensor(mask), tp, dims).numpy(),
        np.asarray(PL.compute_keys_ymajor(jnp.asarray(pos),
                                          jnp.asarray(mask), jp, geom)))


def test_sweep_constants_block_is_make_pvecs_floats():
    """The device block that the kernels read holds, bit for bit, the
    float32 values of the sweeps' constants as host floats (what the C
    struct took before the block moved to the device), and JAX's
    ``_make_pvec`` to an ulp: torch's ``float / tensor`` multiplies by the
    reciprocal, so spiky, visc_lap and poly6 may sit an ulp from JAX's, as
    they did before.  The dims stay host ints."""
    import jax.numpy as jnp
    from sph_tpu.core.params import FluidParams as JFP
    from sph_tpu.neighbors.pallas_sweeps import _make_pvec

    state, params, cfg, _ = port_case("ghosts", "cpu")
    params = params.replace(gravity=torch.tensor([120.5, -980.0, -33.25]))
    pv = sweeps.make_pvec(params, 0.0013, cfg.grid_dims)
    assert pv.consts.dtype == torch.float32
    assert pv.consts.shape == (len(sweeps.CONST_NAMES),)
    assert (pv.nx, pv.ny, pv.nz) == cfg.grid_dims
    assert all(type(d) is int for d in (pv.nx, pv.ny, pv.nz))
    block = pv.consts.numpy().view(np.int32)
    floats = np.asarray([getattr(pv, n) for n in sweeps.CONST_NAMES],
                        np.float32).view(np.int32)
    np.testing.assert_array_equal(block, floats)
    pd = to_numpy(params)
    jp = JFP(shape_type=int(pd.pop("shape_type")),
             **{k: jnp.asarray(v) for k, v in pd.items()})
    jax_block = np.asarray(_make_pvec(jp, np.float32(0.0013)), np.float32)
    assert np.abs(block.astype(np.int64)
                  - jax_block.view(np.int32)).max() <= 1
    assert pv.dt == np.float32(0.0013) and pv.gx == np.float32(120.5)
    assert sweeps.prepare(state, params, 0.0013, cfg).pv == pv


def test_wave_tensors_built_once_give_the_wave_of_host_floats():
    """``frame_prologue`` builds the wave's scalars on the params' device
    once; its frame equals ``wave_impulse`` given the host floats."""
    from sph_tpu_torch.app import configs
    from sph_tpu_torch.physics.impulses import wave_impulse

    state, params, _, _ = port_case("fountain", "cpu")
    state = state.replace(vel=state.vel + 0.5)
    got = configs.frame_prologue("rotated_512k", params, 16)(state)
    want = wave_impulse(state, amplitude=60.0 * float(params.dt) * 16,
                        wavelength=4.0, phase=0.7, direction=(1.0, 0.0, 0.3))
    assert torch.equal(got.vel, want.vel)
    assert not torch.equal(got.vel, state.vel)


def test_program_inputs_round_trip_and_key_on_their_shapes():
    """The program's view of its inputs: the tensors of the state, params,
    buffers, dt and the cell engine's aux in a fixed order, and the rest
    (``shape_type``, the grid dims, None) in a hashable spec that rebuilds
    them; a different ghost count is a different spec of shapes."""
    state, params, cfg, buf = port_case("ghosts", "cpu")
    aux = TSTEP.neighbor_aux(state, params, params.dt, cfg)
    args = (state, params, buf, params.dt, aux)
    leaves, spec = graph._flatten(args)
    hash(spec)
    assert len(leaves) == (len(dataclasses.fields(state))
                           + len(dataclasses.fields(params)) - 1
                           + len(dataclasses.fields(buf)) + 1 + 1 + 5)
    back = graph._unflatten(spec, iter(leaves))
    assert type(back[4]) is sweeps.CellAux and back[4].pv == aux.pv
    assert back[1].shape_type == params.shape_type
    for a, b in zip(graph._flatten(back)[0], leaves):
        assert a is b
    fewer = aux._replace(ghosts=None)
    other, ospec = graph._flatten((state, params, buf, params.dt, fewer))
    assert ospec != spec and len(other) == len(leaves) - 5


# ---------------------------------------------------------------------------
# the card: the captured program against the eager loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("module", ["engine/graph.py", "utils/trace.py"])
def test_runner_and_trace_import_no_kernel_module(module):
    """The frame program's runner and the counters know no module of
    ``neighbors/``, ``physics/`` or ``app/``: launch counts reach them as
    ``launches.*`` counters."""
    path = os.path.join(os.path.dirname(os.path.dirname(graph.__file__)),
                        module)
    with open(path) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [f"{n.module}.{a.name}" for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) for a in n.names]
    assert all(n.level == 0 for n in ast.walk(tree)
               if isinstance(n, ast.ImportFrom))
    ours = {n for n in names if n.startswith("sph_tpu_torch")}
    assert not any(n.startswith(f"sph_tpu_torch.{pkg}")
                   for n in ours for pkg in ("neighbors", "physics", "app"))
    assert ours <= {"sph_tpu_torch.utils.trace"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_CASES)
def test_graph_is_bit_identical_to_eager_on_cuda(cuda, case):
    state, params, cfg, buf = port_case(case, cuda)
    captures = trace.counter("graph.captures")
    got = frames(TSTEP.run_substeps, state, params, cfg, buf)
    assert trace.counter("graph.captures") == captures + 1
    assert_bit_identical(got, frames(TSTEP.run_substeps_eager, state, params,
                                     cfg, buf))


@pytest.mark.cuda
def test_graph_follows_a_gravity_change_on_cuda(cuda):
    state, params, cfg, buf = port_case("fountain", cuda)
    tipped = params.replace(gravity=torch.tensor([300.0, -900.0, 120.0],
                                                 device=cuda))

    def two(run):
        st, b = run(state, params, buf, params.dt, N_SUB, cfg)
        return run(st, tipped, b, params.dt, N_SUB, cfg)
    assert_bit_identical(two(TSTEP.run_substeps),
                         two(TSTEP.run_substeps_eager))


@pytest.mark.cuda
def test_graph_per_substep_count_on_cuda(cuda):
    state, params, cfg, buf = port_case("ghosts", cuda)
    captures = trace.counter("graph.captures")
    for n in (3, 5, 3):
        assert_bit_identical(
            TSTEP.run_substeps(state, params, buf, params.dt, n, cfg),
            TSTEP.run_substeps_eager(state, params, buf, params.dt, n, cfg))
    assert trace.counter("graph.captures") == captures + 2


@pytest.mark.cuda
def test_launch_counts_after_replays_on_cuda(cuda):
    # the container pass: inside the cell engine's reassembly, in the scene
    # stages of the all-pairs kernels; one launch a substep either way
    for case, per_sub in (("ghosts", {"cell_table": 1, "density": 1,
                                      "force_xsph": 1, "container": 1}),
                          ("brute_kernel", {"brute_density": 1,
                                            "brute_force": 1,
                                            "container": 1})):
        state, params, cfg, buf = port_case(case, cuda)
        trace.reset()
        frames(TSTEP.run_substeps, state, params, cfg, buf, n_frames=3)
        counts = trace.launches()
        assert trace.counters()["launches.container"] == 3 * N_SUB
        want = {k: 3 * N_SUB * v for k, v in per_sub.items()}
        if case == "ghosts":        # the ghosts' table, once a frame
            want["cell_table"] += 3
        assert counts == want, case


@pytest.mark.cuda
def test_a_failed_capture_raises_on_cuda(cuda):
    x = torch.ones(8, device=cuda)

    def waits(t):
        return t * float(t.sum())       # a host wait: illegal in a capture
    with pytest.raises(RuntimeError):
        graph.run(("a host wait",), waits, waits, (x,))
    assert ("a host wait",) not in [k[0] for k in graph._PROGRAMS]
