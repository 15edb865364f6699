"""The port's bench entry point (sph_tpu_torch.app.bench), on the CPU with
a 2k fixture and a clock the test controls: the JSON line has ``bench.py``'s
four fields, and its value is fluid rows x substeps / the median frame's
seconds."""
import json

import pytest
import torch

import bench as jax_bench
from sph_tpu_torch.app import bench
from sph_tpu_torch.app.configs import BenchConfig


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU ops on one thread while this module runs: the suite
    runs in several processes at once, where each process's pool of torch
    threads spins against the others'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY = BenchConfig(name="tiny_2k", n_target=2048, box_half=(7.0, 7.0, 7.0))
N_SUB = 3
# seconds the fake clock gives the warm-up frame and the five timed frames
FRAME_SECONDS = [9.0, 0.5, 0.1, 0.3, 0.2, 0.4]


@pytest.fixture
def fake_clock(monkeypatch):
    """``time.perf_counter`` as the bench sees it: each frame reads it
    twice, and the k-th frame lasts ``FRAME_SECONDS[k]``."""
    ticks = []
    now = 0.0
    for s in FRAME_SECONDS:
        ticks += [now, now + s]
        now += s + 1.0
    it = iter(ticks)
    monkeypatch.setattr(bench.time, "perf_counter", lambda: next(it))
    return it


def test_run_reports_the_median_frame(fake_clock, capsys):
    rec = bench.run(TINY, N_SUB, device="cpu")
    assert list(rec) == ["metric", "value", "unit", "vs_baseline"]
    assert rec["metric"] == "particle-steps/sec @ tiny_2k"
    assert rec["unit"] == "particle-steps/sec"
    median = 0.3                       # of 0.5, 0.1, 0.3, 0.2, 0.4
    assert rec["value"] == round(2048 * N_SUB / median, 1)
    assert rec["vs_baseline"] == round(
        2048 * N_SUB / median / bench.REFERENCE_BASELINE_PSTEPS, 3)
    assert next(fake_clock, None) is None          # six frames, no more
    err = capsys.readouterr().err
    assert "min 33.3333" in err and "max 166.6667" in err
    assert "fluid=2048" in err


def test_main_prints_one_json_line(fake_clock, capsys, monkeypatch):
    monkeypatch.setitem(bench.configs.CONFIGS, "tiny_2k", TINY)
    real = bench.run
    monkeypatch.setattr(bench, "run",
                        lambda name, n: real(name, n, device="cpu"))
    bench.main(["tiny_2k", str(N_SUB)])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    rec = json.loads(out[0])
    assert set(rec) == {"metric", "value", "unit", "vs_baseline"}
    assert rec["value"] == round(2048 * N_SUB / 0.3, 1)


@pytest.mark.parametrize("engine, impl", [("brute", "brute"),
                                          ("pallas", "cell")])
def test_main_passes_the_engine_to_the_build(engine, impl, fake_clock,
                                             capsys, monkeypatch):
    """bench.py's third argument (``bench.py:25``) overrides the engine,
    by the JAX package's name: ``brute`` benches the all-pairs oracle."""
    monkeypatch.setitem(bench.configs.CONFIGS, "tiny_2k", TINY)
    real = bench.run
    monkeypatch.setattr(bench, "run", lambda name, n, **kw: real(
        name, n, device="cpu", **kw))
    bench.main(["tiny_2k", str(N_SUB), engine])
    out, err = capsys.readouterr()
    assert f"impl={impl}" in err
    assert json.loads(out)["value"] == round(2048 * N_SUB / 0.3, 1)
    with pytest.raises(NotImplementedError, match="binned"):
        real(TINY, 1, device="cpu", neighbor_impl="binned")


def test_defaults_and_baseline_are_bench_pys(monkeypatch):
    assert bench.REFERENCE_BASELINE_PSTEPS == jax_bench.REFERENCE_BASELINE_PSTEPS
    seen = []
    monkeypatch.setattr(bench, "run", lambda *a: seen.append(a) or {})
    bench.main([])
    assert seen == [("ghost_1m", 20)]
    with pytest.raises(SystemExit, match="unknown config"):
        bench.main(["no_such_config"])


def test_without_a_card_the_default_device_raises():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="cpu"):
        bench.run(TINY, 1)


def test_run_exports_the_frames(tmp_path, monkeypatch, capsys):
    """A configuration with ``viz_export`` writes bench.py's four frames to
    bench_frames/ (under the working directory) after the timed frames:
    960x540 PNGs that decode and are not background; the JSON line keeps
    its four fields."""
    from sph_tpu_torch.viz.splat import read_png
    monkeypatch.chdir(tmp_path)
    cfg = BenchConfig(name="tiny_export", n_target=2048,
                      box_half=(7.0, 7.0, 7.0), viz_export=True)
    rec = bench.run(cfg, 2, device="cpu", frames=1)
    assert list(rec) == ["metric", "value", "unit", "vs_baseline"]
    names = sorted(p.name for p in (tmp_path / "bench_frames").iterdir())
    assert names == sorted(f"tiny_export_{d}.png" for d in
                           ("height", "speed", "pressure", "density"))
    for name in names:
        img = read_png(str(tmp_path / "bench_frames" / name))
        assert img.shape == (540, 960, 3)
        drawn = (img != img[0, 0]).any(axis=-1).sum()
        assert (img[0, 0] == [7, 10, 15]).all() and drawn > 500, name
    assert "viz export (4 drives, 2048 particles)" in capsys.readouterr().err
