"""The plain reference's substep on a few hand-placed rows, and on a small
state against the port's own plain path on the CPU."""
import json
import math
import os

import numpy as np
import pytest
import torch

from benchmark import spawn
from benchmark.reference import sph

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _cfg(name="default_131k", **changes):
    with open(os.path.join(ROOT, "benchmark", "configs", f"{name}.json")) as f:
        return dict(json.load(f), **changes)


def _state(pos, vel=None, ghost=None, face=None):
    n = len(pos)
    rows = {"pos": np.asarray(pos, np.float32),
            "vel": np.zeros((n, 3), np.float32) if vel is None
            else np.asarray(vel, np.float32),
            "ghost": np.zeros(n, np.int32) if ghost is None
            else np.asarray(ghost, np.int32),
            "face": np.full(n, -1, np.int32) if face is None
            else np.asarray(face, np.int32),
            "color_group": np.zeros(n, np.int32)}
    return sph.initial_state(rows, "cpu", pad=4)


def _by_id(st, field, i):
    return st[field][st["orig_id"] == i][0]


def test_one_row_falls_under_gravity():
    cfg = _cfg(box_half=[2.5, 2.5, 2.5])
    frame = sph.Frame(cfg, "cpu")
    st = frame.substep(_state([(0.0, 0.0, 0.0)]))
    dt, g = 1e-3, -980.0
    vy = g * dt * 0.995
    assert float(_by_id(st, "vel", 0)[1]) == pytest.approx(vy, rel=1e-6)
    assert float(_by_id(st, "pos", 0)[1]) == pytest.approx(vy * dt, rel=1e-6)
    # alone, its density is its own poly6 weight, floored at half of rho0
    h = 0.28
    mass = 1000.0 * (0.85 * h) ** 3
    own = mass * 315.0 / (64.0 * math.pi * h ** 9) * h ** 6
    assert float(_by_id(st, "density", 0)) == pytest.approx(max(own, 500.0),
                                                            rel=1e-5)
    # the padding rows stay as they were
    assert torch.equal(st["valid"][st["orig_id"] >= 1],
                       torch.zeros(3, dtype=torch.int32))


def test_a_pair_within_h_pushes_apart_and_sorts_by_cell():
    cfg = _cfg(box_half=[2.5, 2.5, 2.5], gravity=[0.0, 0.0, 0.0])
    frame = sph.Frame(cfg, "cpu")
    # row 0 is in a later cell (larger x) than row 1, 0.1 apart
    st = frame.substep(_state([(0.30, 0.0, 0.0), (0.20, 0.0, 0.0)]))
    assert st["orig_id"][:2].tolist() == [1, 0]
    h = 0.28
    mass = 1000.0 * (0.85 * h) ** 3
    poly6 = 315.0 / (64.0 * math.pi * h ** 9)
    rho = mass * poly6 * (h ** 6 + (h ** 2 - 0.01) ** 3)
    assert float(_by_id(st, "density", 0)) == pytest.approx(rho, rel=1e-5)
    # compressed beyond rest? then the pressure pushes the two apart
    if rho > 1000.0:
        assert float(_by_id(st, "vel", 0)[0]) > 0.0
        assert float(_by_id(st, "vel", 1)[0]) < 0.0


def test_box_container_clamps_and_reflects():
    cfg = _cfg(box_half=[2.5, 2.5, 2.5], gravity=[0.0, 0.0, 0.0])
    frame = sph.Frame(cfg, "cpu")
    st = _state([(0.0, -2.499, 0.0)], vel=[(1.0, -50.0, 0.0)])
    st = frame.substep(st)
    pos, vel = _by_id(st, "pos", 0), _by_id(st, "vel", 0)
    assert float(pos[1]) == pytest.approx(-2.5)
    # damped to (0.995, -49.75, 0) by the substep, then restitution 0.15
    # on the normal part and friction 0.02 on the tangent
    assert float(vel[1]) == pytest.approx(0.15 * 49.75, rel=1e-5)
    assert float(vel[0]) == pytest.approx(0.98 * 0.995, rel=1e-5)
    assert float(vel[2]) == 0.0


def test_active_ghost_is_a_fixed_source():
    cfg = _cfg(box_half=[2.5, 2.5, 2.5], gravity=[0.0, 0.0, 0.0])
    frame = sph.Frame(cfg, "cpu")
    st = _state([(0.0, 2.4, 0.0), (0.0, 2.5 + 0.126, 0.0)],
                ghost=[0, 1], face=[-1, 3])
    out = frame.substep(st)
    assert torch.equal(_by_id(out, "pos", 1), st["pos"][1])
    assert float(_by_id(out, "density", 1)) == 1000.0
    assert torch.equal(_by_id(out, "vel", 1), torch.zeros(3))
    alone = frame.substep(_state([(0.0, 2.4, 0.0)]))
    # the ghost 0.226 above adds to the fluid row's density
    assert float(_by_id(out, "density", 0)) > float(
        _by_id(alone, "density", 0))


def test_reference_follows_the_ports_plain_path():
    """1,500 rows with a ghost shell, 4 substeps: the reference against the
    port's own CPU path (its kernels' plain versions)."""
    from benchmark.system import System
    cfg = _cfg("ghost_1m", fluid_rows=1500, box_half=[2.5, 2.5, 2.5])
    traffic = {"substeps": 4, "export": None}
    rows = spawn.spawn(cfg, 2**31 + 99)
    port = System(cfg, traffic, rows, "cpu")
    fields = System.fields
    assert fields(port.state0).keys() == set(sph.FIELDS)
    out = fields(port.frame(port.state0))
    ref = sph.Frame(cfg, "cpu").run(sph.initial_state(rows, "cpu"), 4)
    from benchmark import check
    nums = check.compare_states(out, ref, {"pos": 1e-5, "vel": 1e-3},
                                sph.Frame(cfg, "cpu"))
    assert nums["pos_apart"] == nums["vel_apart"] == 0.0
    assert nums["pos_gap"] < 1e-5
    assert nums["vel_gap"] < 1e-3
    assert nums["rho_gap"] < 0.05
    assert nums["foam_gap"] < 1e-6
    assert nums["order_breaks"] == 0


def test_order_breaks_leave_out_fluid_rows_on_a_cell_plane_only():
    """In a rotated box, a fluid row on a wall (a plane between two cells)
    may sit anywhere in the sort; a row off every plane, fluid or ghost,
    may not."""
    from benchmark import check
    cfg = _cfg(box_half=[2.5, 2.5, 2.5], box_center=[0.5, -1.0, 2.0],
               box_euler_deg=[20.0, 0.0, 30.0])
    frame = sph.Frame(cfg, "cpu")
    # the centre of the grid's cell k on an axis; the walls at +-2.5 are
    # planes between cells (the grid starts one h outside them)
    mid = lambda k: -2.78 + (k + 0.5) * 0.28  # noqa: E731
    local = np.array([[mid(1), mid(9), mid(9)],    # 0: fluid, inside
                      [-2.5, mid(9), mid(9)],      # 1: fluid, on a wall
                      [mid(9), mid(9), mid(9)],    # 2: fluid, inside
                      [mid(14), mid(9), mid(9)],   # 3: ghost, inside
                      [-2.5, mid(12), mid(9)]],    # 4: ghost, on a wall
                     np.float32)
    pos = np.asarray(cfg["box_center"], np.float32) + local @ sph.rotation(
        cfg["box_euler_deg"]).T
    ref = _state(pos, ghost=[0, 0, 0, 1, 1])
    gap = frame.cell_plane_gap(ref["pos"])
    assert float(gap[1]) < 1e-5 and float(gap[4]) < 1e-5
    assert float(gap[[0, 2, 3]].min()) > 0.1

    def breaks(order):
        out = {k: v[torch.tensor(order + [5, 6, 7])] for k, v in
               ref.items()}
        return check.order_breaks(out, ref, frame, 1e-3)
    assert breaks([0, 1, 2, 3, 4]) == 0
    assert breaks([1, 0, 2, 3, 4]) == 0
    assert breaks([0, 2, 3, 4, 1]) == 0
    assert breaks([2, 0, 1, 3, 4]) == 1
    assert breaks([0, 1, 2, 4, 3]) == 1
    assert breaks([4, 0, 1, 2, 3]) == 1


WAVE = {"kind": "wave", "strength": 60.0, "wavelength": 4.0, "phase": 0.7,
        "direction": [1.0, 0.0, 0.3]}


def _waved(**changes):
    return _cfg(**dict(dict(fluid_rows=1500, box_half=[2.5, 2.5, 2.5],
                            box_euler_deg=[20.0, 0.0, 30.0],
                            frame_prologue=WAVE),
                       **changes))


@pytest.mark.parametrize("wave", [WAVE, dict(WAVE, wavelength=3.3,
                                             phase=-1.9,
                                             direction=[0.2, -0.7, 0.5])])
def test_reference_kick_equals_the_ports_wave_impulse(wave):
    """The reference's wave kick against the port's
    ``physics.impulses.wave_impulse`` as the harness's ``System.prologue``
    calls it, on the CPU, ghosts and padding rows included.  Both run the
    same float32 operations in the same order (the dot product as one
    matrix product, 2 pi / lambda rounded once), so the tolerance is 0 at
    the configuration's wavelength of 4; at another wavelength the port's
    2 pi / lambda is a reciprocal times 2 pi, one rounding more than the
    reference's quotient, which moves theta by an ulp of k (|p . d| < 6
    here) and a kick by at most A * 6 * 2**-23 * k, under 2e-6."""
    from benchmark.system import System
    cfg = _waved(frame_prologue=wave)
    cfg.update(ghost_shell=True)
    rows = spawn.spawn(cfg, 2**31 + 41)
    port = System(cfg, {"substeps": 16, "export": None}, rows, "cpu")
    st = port.state0.replace(vel=torch.randn(port.state0.n, 3,
                                             generator=torch.Generator()
                                             .manual_seed(3)))
    got = System.fields(port.prologue(st))
    want = sph.Frame(cfg, "cpu").kick(System.fields(st), 16)
    tol = 0.0 if wave["wavelength"] == 4.0 else 2e-6
    assert float((got["vel"] - want["vel"]).abs().max()) <= tol
    kicked = (st.ghost == 0) & (st.valid > 0)
    assert torch.equal(got["vel"][~kicked], st.vel[~kicked])
    assert float((got["vel"] - st.vel)[kicked].abs().max()) > 0.5


def test_reference_frame_starts_with_the_kick_once():
    cfg = _waved()
    rows = spawn.spawn(cfg, 2**31 + 42)
    frame = sph.Frame(cfg, "cpu")
    st = sph.initial_state(rows, "cpu")
    want = frame.kick(st, 2)
    for _ in range(2):
        want = frame.substep(want)
    got = frame.run(st, 2)
    assert all(torch.equal(got[k], want[k]) for k in sph.FIELDS)
    # without the key, a frame is its substeps alone
    plain = sph.Frame(dict(cfg, frame_prologue=None), "cpu")
    want = plain.substep(plain.substep(st))
    got = plain.run(st, 2)
    assert all(torch.equal(got[k], want[k]) for k in sph.FIELDS)


def test_control_kick_rounds_the_dot_product_to_tf32():
    cfg = _waved()
    st = sph.initial_state(spawn.spawn(cfg, 2**31 + 43), "cpu")
    exact = sph.Frame(cfg, "cpu").kick(st, 16)["vel"]
    low = sph.Frame(cfg, "cpu", low=True).kick(st, 16)["vel"]
    gap = float((exact - low).abs().max())
    assert 1e-5 < gap < 1e-2


def test_unknown_prologue_raises():
    with pytest.raises(ValueError, match="frame_prologue kind 'vortex'"):
        sph.Frame(_waved(frame_prologue=dict(WAVE, kind="vortex")), "cpu")
    from benchmark.system import System
    cfg = _waved(frame_prologue=dict(WAVE, kind="vortex"))
    with pytest.raises(ValueError, match="frame_prologue kind 'vortex'"):
        System(cfg, {"substeps": 16, "export": None},
               spawn.spawn(_waved(), 2**31 + 44), "cpu")
