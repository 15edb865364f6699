"""The port's doc gallery (``app/gallery.py``), preset generator
(``app/gen_presets.py``) and table of engine names (``engine.step.ENGINES``)
against the JAX package's ``scripts/make_gallery.py``,
``scripts/gen_presets.py`` and engines, on the CPU.

- The preset generator: byte for byte on ``presets/*.txt`` and on the JAX
  script's output.
- The gallery's looks: the five calls of ``scripts/make_gallery.py``, read
  with ``ast`` (importing the script would set JAX's compilation cache for
  the whole test process).
- Each look at a reduced row count (``build(name, device="cpu",
  count=COUNT)``), held against the JAX ``Scene`` with the same settings
  and seed:

  - the torus look's physics after 2 frames (32 substeps) against the
    script's engine, ``binned``, within the ROADMAP's engine tolerances
    (pos 1e-4, vel 1e-3, density 1.0, ``tests/test_brute_pallas.py:40-42``);
  - the river look's physics after its first substep against JAX
    ``brute``.  The look keeps the box spawn under the terrain, which
    lifts its lower layers into one sheet (ROADMAP R12) that amplifies
    rounding: JAX ``brute`` started one ulp away parts from JAX ``brute``
    by 2.7e-3 in velocity at the second substep, the port (its cell
    engine and its all-pairs oracle alike) by 4.7e-3, while the port's
    cell engine stays within 4.3e-4 of its all-pairs oracle over four
    (printed by ``PYTHONPATH=. python tests/test_torch_gallery.py
    river_canyon 4``), so one substep is what the tolerances can hold
    against JAX, and four the port's engines against each other;
  - the frame of one state, each look's own settings and zoom at
    ``FRAME_W`` x ``FRAME_H``: no channel more than 1/255 from the JAX
    package's, the port's state copied into one JAX scene for all five
    (measured: equal).
"""
import ast
import ctypes
import dataclasses
import filecmp
import importlib.util
import os
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_tpu import native as jax_native
from sph_tpu.core.state import ParticleState as JParticleState
from sph_tpu.scene import reaction as JR
from sph_tpu.scene import river as JRV
from sph_tpu.scene import scene as JSC
from sph_tpu.scene import settings as JSET
from sph_tpu.viz import camera as JCAM
from sph_tpu_torch.app import bench, configs, gallery, gen_presets
from sph_tpu_torch.app import main as TMAIN
from sph_tpu_torch.engine import step
from sph_tpu_torch.scene import scene as TSC
from sph_tpu_torch.scene import settings as TSET

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POS_TOL, VEL_TOL, RHO_TOL = 1e-4, 1e-3, 1.0
COUNT = 600                  # asked rows of each look here (768 spawned)
FRAME_W, FRAME_H = 96, 54
# ROADMAP R13: the JAX package's engine names and the port's own
WANT_ENGINE = {"auto": "cell", "cell": "cell", "binned": "cell",
               "pallas": "cell", "brute": "brute",
               "brute_pallas": "brute_kernel", "brute_kernel": "brute_kernel"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU ops on one thread while this module runs: the suite
    runs in several processes at once, where each process's pool of torch
    threads spins against the others'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_libs(tmp_path_factory):
    """The JAX package's host rasterizers built from its own sources into
    a directory of this module's (``sph_tpu.native.load`` would build into
    the package's ``_build/``, which another test process may be
    writing)."""
    out = {}
    d = tmp_path_factory.mktemp("jax_native")
    for name in ("tri_raster", "splat_raster"):
        src = os.path.join(os.path.dirname(jax_native.__file__),
                           f"{name}.cpp")
        so = str(d / f"{name}.so")
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17", src,
                        "-o", so], check=True, capture_output=True)
        out[name] = ctypes.CDLL(so)
    return out


@pytest.fixture
def jax_native_libs(jax_libs, monkeypatch):
    for name, lib in jax_libs.items():
        monkeypatch.setitem(jax_native._CACHE, name, lib)


def fluid_rows(state, field):
    """``field`` of the state's rows in ``orig_id`` order, padding
    dropped."""
    get = lambda t: t.cpu().numpy() if hasattr(t, "cpu") else np.asarray(t)
    valid = get(state.valid) > 0
    order = np.argsort(np.where(valid, get(state.orig_id), 1 << 30),
                       kind="stable")[:valid.sum()]
    return get(getattr(state, field))[order]


def errors(port, jsc):
    return [float(np.abs(fluid_rows(port.state, f)
                         - fluid_rows(jsc.state, f)).max())
            for f in ("pos", "vel", "density")]


def jax_twin(port, name, impl):
    """The JAX ``Scene`` of look ``name`` with the port scene's settings,
    the look's seed and river, on engine ``impl``."""
    look = gallery.LOOKS[name]
    jsc = JSC.Scene(JSET.SceneSettings(**dataclasses.asdict(port.settings)),
                    neighbor_impl=impl, seed=look.seed)
    if look.river is not None:
        jsc.enable_river(look.river)
    return jsc


# --- app/gen_presets ----------------------------------------------------------

def load_script(name):
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_gen_presets_writes_the_shipped_files(tmp_path, capsys):
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    paths = gen_presets.main([str(ours)])
    load_script("gen_presets").main(str(theirs))
    capsys.readouterr()
    names = sorted(os.listdir(ours))
    assert len(paths) == len(names) == 14
    assert names == sorted(f for f in os.listdir(os.path.join(REPO, "presets"))
                           if f.endswith(".txt"))
    assert names == sorted(os.listdir(theirs))
    for f in names:
        data = (ours / f).read_bytes()
        assert data == open(os.path.join(REPO, "presets", f), "rb").read(), f
        assert data == (theirs / f).read_bytes(), f
    # deterministic: a second run rewrites the same bytes
    again = tmp_path / "again"
    gen_presets.main([str(again)])
    capsys.readouterr()
    assert filecmp.cmpfiles(ours, again, names, shallow=False)[0] == names


def test_gen_presets_needs_an_out_dir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as exc:
        gen_presets.main([])
    assert exc.value.code != 0
    assert os.listdir(tmp_path) == []


# --- app/gallery: the looks ---------------------------------------------------

def script_looks():
    """(base settings, {look: (settings, seed, frames, zoom, river seed)})
    of ``scripts/make_gallery.py``, read from its source: ``base_settings``'s
    assignments, and in ``main`` each ``Scene(...)``, the assignments to
    its settings, ``enable_river``, ``settle`` and ``shot``."""
    src = open(os.path.join(REPO, "scripts", "make_gallery.py")).read()
    defs = {n.name: n for n in ast.parse(src).body
            if isinstance(n, ast.FunctionDef)}
    lit = ast.literal_eval
    base = {}
    for node in defs["base_settings"].body:
        if (isinstance(node, ast.Assign)
                and isinstance(node.targets[0], ast.Attribute)):
            base[node.targets[0].attr] = lit(node.value)
    settle_default = lit(defs["settle"].args.defaults[0])
    shot_default = lit(defs["shot"].args.defaults[0])

    def kwargs(call):
        assert call.func.id == "base_settings" and not call.args
        return {k.arg: lit(k.value) for k in call.keywords}

    looks, names, cur = {}, {}, {}
    for node in defs["main"].body:
        if isinstance(node, ast.Assign):
            target, value = node.targets[0], node.value
            if isinstance(target, ast.Attribute):       # st.x = v
                names[target.value.id][target.attr] = lit(value)
            elif value.func.id == "base_settings":      # st = base_settings()
                names[target.id] = kwargs(value)
            else:                                       # sc = Scene(...)
                assert value.func.id == "Scene"
                arg = value.args[0]
                kw = {k.arg: lit(k.value) for k in value.keywords}
                cur = dict(settings=(names[arg.id] if isinstance(arg, ast.Name)
                                     else kwargs(arg)),
                           engine=kw["neighbor_impl"], seed=kw["seed"],
                           river=None)
        elif isinstance(node, ast.Expr):
            call = node.value
            if isinstance(call.func, ast.Attribute):
                if call.func.attr == "enable_river":
                    cur["river"] = lit(call.args[0])
                else:                                   # os.makedirs(OUT)
                    assert ast.unparse(call.func) == "os.makedirs"
            elif call.func.id == "settle":
                cur["frames"] = (lit(call.args[1]) if len(call.args) > 1
                                 else settle_default)
            elif call.func.id == "shot":
                zoom = {k.arg: lit(k.value) for k in call.keywords}
                cur["zoom"] = zoom.get("zoom", shot_default)
                looks[lit(call.args[0])] = cur
    return base, looks


def test_looks_are_the_scripts():
    base, looks = script_looks()
    assert gallery.BASE == base
    assert list(gallery.LOOKS) == list(looks)
    assert [look["frames"] for look in looks.values()] == [30, 30, 30, 40, 45]
    for name, want in looks.items():
        got = gallery.LOOKS[name]
        assert want["engine"] == gallery.ENGINE == "binned"
        assert (got.settings, got.seed, got.frames, got.zoom, got.river) == (
            want["settings"], want["seed"], want["frames"], want["zoom"],
            want["river"]), name
    src = open(os.path.join(REPO, "scripts", "make_gallery.py")).read()
    assert "W, H = 480, 270" in src and (gallery.W, gallery.H) == (480, 270)


def test_build_makes_the_looks_scene():
    for name, look in gallery.LOOKS.items():
        scene = gallery.build(name, device="cpu", count=COUNT)
        s = scene.settings
        for k, v in {**gallery.BASE, **look.settings,
                     "particle_count": COUNT}.items():
            assert getattr(s, k) == v, (name, k)
        assert (scene.seed, scene.neighbor_impl) == (look.seed, "binned")
        assert scene.config.neighbor_impl == "cell"
        assert scene.config.river_mode == (look.river is not None)
        assert scene.state.pos.device.type == "cpu"
    full = gallery.build("river_canyon", device="cpu")
    assert full.settings.particle_count == 2000


def test_main_needs_an_out_dir_and_writes_nothing_else(tmp_path,
                                                       monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as exc:
        gallery.main([], device="cpu")
    assert exc.value.code != 0
    assert os.listdir(tmp_path) == []


def test_main_renders_the_five_stills(tmp_path, monkeypatch, capsys):
    """``main`` at a reduced size (the rows through ``build``, the frames
    through ``settle``): five PNGs of W x H, read back, not uniform."""
    from sph_tpu_torch.viz.splat import read_png
    build, settle = gallery.build, gallery.settle
    monkeypatch.setattr(gallery, "build", lambda name, device=None: build(
        name, device=device, count=256))
    monkeypatch.setattr(gallery, "settle", lambda scene, frames=30: settle(
        scene, 1))
    out = gallery.main([str(tmp_path / "stills")], device="cpu")
    capsys.readouterr()
    assert [name for name, _, _ in out] == list(gallery.LOOKS)
    assert sorted(os.listdir(tmp_path / "stills")) == sorted(
        f"{name}.png" for name in gallery.LOOKS)
    for name, scene, path in out:
        img = read_png(path)
        assert img.shape == (gallery.H, gallery.W, 3), name
        assert (img != img[0, 0]).any(), name
        assert scene.sim_time == pytest.approx(1 / 60)


# --- the looks against the JAX Scene --------------------------------------------

def test_torus_look_matches_jax_binned():
    port = gallery.build("torus_two_color", device="cpu", count=COUNT)
    jsc = jax_twin(port, "torus_two_color", "binned")
    assert np.asarray(jsc.params.shape_type) == 3
    for frame in range(2):
        assert port.update(gallery.FRAME_DT) == jsc.update(gallery.FRAME_DT)
    got = errors(port, jsc)
    for name, g, tol in zip(("pos", "vel", "density"), got,
                            (POS_TOL, VEL_TOL, RHO_TOL)):
        assert g <= tol, (name, got)


def test_river_look_matches_jax_brute_over_its_first_substep():
    port = gallery.build("river_canyon", device="cpu", count=COUNT)
    jsc = jax_twin(port, "river_canyon", "brute")
    np.testing.assert_array_equal(port.buffers.terrain.numpy(),
                                  np.asarray(jsc.buffers.terrain))
    assert port.config.river_mode and jsc.config.river_mode
    assert port.update(gallery.FRAME_DT, max_substeps=1) == jsc.update(
        gallery.FRAME_DT, max_substeps=1) == 1
    got = errors(port, jsc)
    for name, g, tol in zip(("pos", "vel", "density"), got,
                            (POS_TOL, VEL_TOL, RHO_TOL)):
        assert g <= tol, (name, got)


@pytest.fixture(scope="module")
def jax_canvas():
    """One JAX scene that renders every look's state (rendering compiles
    no physics)."""
    return JSC.Scene(JSET.SceneSettings(particle_count=1000),
                     neighbor_impl="cell", seed=0)


def port_copy_to_jax(port, jsc):
    """The port scene's state, settings, phases, live values, camera and
    river into the JAX scene ``jsc``, so both render the same frame."""
    jsc.settings = JSET.SceneSettings(**dataclasses.asdict(port.settings))
    jsc.state = JParticleState(**{
        f.name: jnp.asarray(getattr(port.state, f.name).numpy())
        for f in dataclasses.fields(port.state)})
    jsc.phases = JR.ReactionPhases(**dataclasses.asdict(port.phases))
    jsc.live = JR.LiveValues(**dataclasses.asdict(port.live))
    jsc.camera = JCAM.OrbitCamera(**dataclasses.asdict(port.camera))
    jsc.last_frame_dt = port.last_frame_dt
    jsc.post_state = None
    jsc.river_spec = None
    if port.river_spec is not None:
        jsc.river_spec = JRV.RiverSpec(**dataclasses.asdict(port.river_spec))
        jsc.buffers = jsc.buffers.replace(
            terrain=jnp.asarray(port.buffers.terrain.numpy()))


@pytest.mark.parametrize("name", list(gallery.LOOKS))
def test_look_frame_matches_jax_on_the_same_state(name, jax_canvas,
                                                  jax_native_libs,
                                                  monkeypatch):
    look = gallery.LOOKS[name]
    port = gallery.build(name, device="cpu", count=COUNT)
    gallery.settle(port, 1)
    port_copy_to_jax(port, jax_canvas)
    monkeypatch.setattr(gallery, "W", FRAME_W)
    monkeypatch.setattr(gallery, "H", FRAME_H)
    got = gallery.frame(port, look.zoom)
    distance = port.camera.distance
    jax_canvas.camera.distance = distance * look.zoom
    want = jax_canvas.render(FRAME_W, FRAME_H)
    assert port.camera.distance == distance
    assert got.shape == (FRAME_H, FRAME_W, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert (got != got[0, 0]).any()


# --- engine.step.ENGINES ------------------------------------------------------

TINY = configs.BenchConfig(name="tiny", n_target=256,
                           box_half=(2.0, 2.0, 2.0))


@pytest.mark.parametrize("name", list(WANT_ENGINE))
def test_every_engine_name_runs_its_port_engine(name):
    want = WANT_ENGINE[name]
    assert step.engine(name) == want
    state, params, sim = configs.build(TINY, neighbor_impl=name,
                                       device="cpu")
    assert sim.neighbor_impl == want
    s = TSET.SceneSettings(particle_count=256, box_half=[2.0, 2.0, 2.0])
    scene = TSC.Scene(s, neighbor_impl=name, device="cpu")
    assert (scene.neighbor_impl, scene.config.neighbor_impl) == (name, want)
    assert scene.update(1 / 60, max_substeps=1) == 1
    assert np.isfinite(scene.state.pos.numpy()).all()
    scene.respawn()
    assert scene.config.neighbor_impl == want


def test_the_table_keeps_the_jax_packages_choices():
    """The table holds the JAX package's names and the port's all-pairs
    kernels' own; ``--impl`` offers the JAX package's choices
    (``sph_tpu/app/main.py:26-28``)."""
    assert list(step.ENGINES) == ["auto", "cell", "binned", "pallas",
                                  "brute", "brute_pallas", "brute_kernel"]
    assert set(step.ENGINES.values()) == {"cell", "brute", "brute_kernel"}
    assert sorted(TMAIN.IMPL_CHOICES) == sorted(
        ["auto", "brute", "brute_pallas", "cell", "binned", "pallas"])


def test_an_unknown_engine_raises_in_the_constructor(monkeypatch):
    spawned = []
    monkeypatch.setattr(TSC.Scene, "respawn", lambda self: spawned.append(1))
    with pytest.raises(ValueError, match="binned.*brute_kernel"):
        TSC.Scene(neighbor_impl="no_such_engine", device="cpu")
    assert spawned == []
    with pytest.raises(ValueError, match="no_such_engine"):
        configs.build(TINY, neighbor_impl="no_such_engine", device="cpu")


def test_bench_takes_binned(capsys):
    """``app.bench <config> <n> binned`` runs the cell engine, as
    ``bench.py <config> <n> binned`` runs the JAX package's."""
    rec = bench.run(TINY, 1, device="cpu", frames=1, neighbor_impl="binned")
    assert "impl=cell" in capsys.readouterr().err
    assert rec["value"] > 0


def port_twin(port, name, impl):
    """The port ``Scene`` of look ``name`` with ``port``'s settings, the
    look's seed and river, on engine ``impl``, on the CPU."""
    look = gallery.LOOKS[name]
    twin = TSC.Scene(TSET.SceneSettings(**dataclasses.asdict(port.settings)),
                     neighbor_impl=impl, seed=look.seed, device="cpu")
    if look.river is not None:
        twin.enable_river(look.river)
    return twin


def one_ulp_up(jsc):
    """``jsc``'s valid rows moved one float32 ulp up in every coordinate."""
    pos = np.asarray(jsc.state.pos)
    valid = (np.asarray(jsc.state.valid) > 0)[:, None]
    jsc.state = dataclasses.replace(jsc.state, pos=jnp.asarray(np.where(
        valid, np.nextafter(pos, np.float32(np.inf)), pos)))


DRIFTS = ("port cell / JAX brute", "port brute / JAX brute",
          "port cell / port brute", "JAX brute 1 ulp up / JAX brute")


def look_drift(name, substeps, count=COUNT):
    """Per substep of look ``name``'s first frame (one substep a call):
    (pos, vel, density) over the fluid rows for each pair of
    :data:`DRIFTS`: the port's cell engine (the look's own) and its
    all-pairs oracle against JAX ``brute`` and against each other, and
    JAX ``brute`` from a start one ulp away against JAX ``brute``."""
    cell = gallery.build(name, device="cpu", count=count)
    brute = port_twin(cell, name, "brute")
    jax_brute, jax_ulp = (jax_twin(cell, name, "brute") for _ in range(2))
    one_ulp_up(jax_ulp)
    pairs = ((cell, jax_brute), (brute, jax_brute), (cell, brute),
             (jax_ulp, jax_brute))
    for done in range(1, substeps + 1):
        for sc in (cell, brute, jax_brute, jax_ulp):
            sc.update(gallery.FRAME_DT, max_substeps=1)
        yield done, {k: errors(a, b) for k, (a, b) in zip(DRIFTS, pairs)}


def test_river_look_drifts_from_jax_as_a_one_ulp_start_does():
    """Why the river look is held one substep: its sheet parts JAX
    ``brute`` from itself, started one ulp away, by more than the
    velocity tolerance at the second substep, as the port parts from it
    there; the port's cell engine follows its all-pairs oracle within
    the tolerances over four substeps all the same."""
    for done, drift in look_drift("river_canyon", 4):
        for key in ("port cell / port brute",) + (
                ("port cell / JAX brute", "JAX brute 1 ulp up / JAX brute")
                if done == 1 else ()):
            for name, g, tol in zip(("pos", "vel", "density"), drift[key],
                                    (POS_TOL, VEL_TOL, RHO_TOL)):
                assert g <= tol, (done, key, name, drift)
        if done == 2:
            assert drift["JAX brute 1 ulp up / JAX brute"][1] > VEL_TOL, drift


if __name__ == "__main__":
    import sys

    import jax
    jax.config.update("jax_platforms", "cpu")
    name = sys.argv[1] if len(sys.argv) > 1 else "river_canyon"
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    for done, drift in look_drift(name, n):
        for key, err in drift.items():
            print(f"{name} at {COUNT} asked rows, substep {done}: {key} "
                  f"(pos, vel, density) {err}", flush=True)
