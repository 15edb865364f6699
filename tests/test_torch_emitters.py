"""The fountain's and the river's recycling emitters
(sph_tpu_torch.physics.emitters) against ``sph_tpu.physics.emitters``, row
by row: the same rows respawn (their hash is keyed by ``orig_id``, so the
rows are shuffled first), at the same spots with the same velocities, over
several seeds of the fountain's dispatch counter, the uint32 edge ones
included."""
import dataclasses

import numpy as np
import pytest
import torch

from sph_tpu.core import params as JP
from sph_tpu.core import state as JS
from sph_tpu.physics import emitters as JE
from sph_tpu_torch.core.convert import params_from_numpy, state_from_numpy
from sph_tpu_torch.physics import emitters as TE

# the seed is the fountain's dispatch counter, a uint32 that wraps
SEEDS = (0, 1, 7, 1234567, 2**31 + 5, 2**32 - 1)
N = 2048


def to_numpy(obj):
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def shuffled_state(seed=3):
    """A JAX state of N rows scattered over the box of half 7 and past its
    river sink, rows shuffled so that orig_id is not the row index, with
    ghosts and padding."""
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    pos = rng.uniform([-7.0, -9.5, -7.0], [7.0, 7.0, 10.0], (N, 3))
    spawn = JS.SpawnResult(
        pos=pos.astype(np.float32),
        vel=rng.standard_normal((N, 3)).astype(np.float32),
        ghost=(rng.uniform(size=N) > 0.95).astype(np.int32),
        face=np.full((N,), -1, np.int32),
        color_group=(rng.uniform(size=N) > 0.5).astype(np.int32), count=N)
    st = JS.state_from_spawn(spawn, pad_to=N + 64)
    perm = jnp.asarray(rng.permutation(st.n))
    st = st.replace(**{f.name: getattr(st, f.name)[perm]
                       for f in dataclasses.fields(st)})
    return st.replace(density=jnp.full((st.n,), 1234.0, jnp.float32),
                      pressure=jnp.full((st.n,), 56.0, jnp.float32),
                      acc=jnp.ones((st.n, 3), jnp.float32))


def port(obj):
    conv = (params_from_numpy if isinstance(obj, JP.FluidParams)
            else state_from_numpy)
    return conv(to_numpy(obj), device="cpu")


def check_rows(got, want, start, moved):
    """``got`` (the port's) equals ``want`` (JAX's) on every row; the rows
    ``moved`` changed, the others kept ``start``'s values."""
    for f, atol in (("pos", 2e-5), ("vel", 2e-5), ("acc", 0.0),
                    ("density", 0.0), ("pressure", 0.0)):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=atol, err_msg=f)
    for f in ("ghost", "valid", "orig_id", "color_group", "foam"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(start, f)))
    keep = ~moved.numpy()
    for f in ("pos", "vel", "acc"):
        np.testing.assert_array_equal(getattr(got, f).numpy()[keep],
                                      np.asarray(getattr(start, f))[keep])
    assert (got.acc.numpy()[~keep] == 0).all()


def test_lcg_matches_uint32():
    """``_lcg_next`` in int64 is the JAX package's uint32 step."""
    import jax.numpy as jnp
    s0 = np.asarray([0, 1, 2**24 - 1, 2**31, 2**32 - 1, 3735928559],
                    np.uint32)
    js, ts = jnp.asarray(s0), torch.as_tensor(s0.astype(np.int64))
    for _ in range(6):
        js, ju = JE._lcg_next(js)
        ts, tu = TE._lcg_next(ts)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(
            np.int64))
        np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))


@pytest.mark.parametrize("seed", SEEDS)
def test_fountain_recycle_matches_jax(seed):
    import jax.numpy as jnp
    js = shuffled_state()
    jp = JP.FluidParams.default(fountain_drain_per_sec=150.0,
                                fountain_drain_level=4.0).derive_mass()
    want = JE.fountain_recycle(js, jp, jp.dt, jnp.uint32(seed))
    ts, tp = port(js), port(jp)
    got, mask = TE.fountain_recycle(ts, tp, tp.dt,
                                    torch.tensor(seed, dtype=torch.int64))
    moved = (np.asarray(want.pos) != np.asarray(js.pos)).any(-1)
    np.testing.assert_array_equal(mask.numpy(), moved)
    # chance 0.15 a substep for the fluid rows below the drain plane
    below = int(((ts.pos[:, 1] < -3.0) & ts.fluid_mask()).sum())
    assert 0.08 * below < int(mask.sum()) < 0.25 * below
    check_rows(got, want, js, mask)


def test_fountain_seeds_draw_other_rows():
    """Successive dispatches recycle different rows of the same state."""
    js = shuffled_state()
    jp = JP.FluidParams.default(fountain_drain_per_sec=150.0,
                                fountain_drain_level=4.0).derive_mass()
    ts, tp = port(js), port(jp)
    masks = [TE.fountain_recycle(ts, tp, tp.dt, torch.tensor(s))[1]
             for s in SEEDS[:3]]
    assert not torch.equal(masks[0], masks[1])
    assert not torch.equal(masks[1], masks[2])


@pytest.mark.parametrize("sink", [(-8.5, 9.0), (-6.0, 4.0)])
def test_stream_emit_matches_jax(sink):
    js = shuffled_state(seed=5)
    jp = JP.FluidParams.default(river_sink_y=sink[0],
                                river_sink_z_max=sink[1],
                                river_amp=1.4, river_phase=0.3).derive_mass()
    want = JE.stream_emit(js, jp)
    ts, tp = port(js), port(jp)
    got, dead = TE.stream_emit(ts, tp)
    fl = ts.fluid_mask()
    expect = fl & ((ts.pos[:, 1] < sink[0]) | (ts.pos[:, 2] > sink[1]))
    assert torch.equal(dead, expect) and int(dead.sum()) > 50
    check_rows(got, want, js, dead)
    np.testing.assert_array_equal(
        got.vel.numpy()[dead.numpy()],
        np.broadcast_to(np.asarray(jp.river_emitter_vel),
                        (int(dead.sum()), 3)))
    # a row always respawns at the same spot: its hash is its orig_id's
    sunk = ts.replace(pos=ts.pos - torch.tensor([0.0, 100.0, 0.0]))
    again, dead_all = TE.stream_emit(sunk, tp)
    assert torch.equal(dead_all, fl)
    assert torch.equal(again.pos[dead], got.pos[dead])
