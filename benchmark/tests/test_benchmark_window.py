"""The window's statistics: the rate over every completed frame, the 95th
percentile over every frame, and the seeded sample of frames."""
import statistics

import pytest

from benchmark import window


def test_rate_counts_every_frame_over_the_whole_window():
    # 7 frames of 16 substeps of 1,000 rows in 0.35 s
    assert window.rate(16 * 1000, 7, 0.35) == pytest.approx(320_000.0)
    with pytest.raises(ValueError):
        window.rate(16, 0, 1.0)


def test_p95_takes_every_frame():
    d = [0.010] * 95 + [0.020, 0.030, 0.040, 0.050, 0.060]
    # ranks 94 and 95 of 100 (0-based) are 0.010 and 0.020: 95th at 0.0105
    assert window.p95(d) == pytest.approx(0.01 + 0.05 * 0.01)
    assert window.p95(d) == statistics.quantiles(d, n=100,
                                                 method="inclusive")[94]
    # one slow frame among twenty moves the 95th percentile
    assert window.p95([0.01] * 19 + [1.0]) > 0.05
    assert window.p95([0.25]) == 0.25


def test_reservoir_is_fixed_by_seed_and_covers_the_stream():
    def draw(seed, n, k=3):
        r = window.Reservoir(k, seed)
        for i in range(n):
            r.offer(f"frame{i}")
        return r.sample()

    assert draw(2**31 + 7, 500) == draw(2**31 + 7, 500)
    assert draw(1, 500) != draw(2, 500)
    assert [i for i, _ in draw(5, 2)] == [0, 1]
    picked = set()
    for seed in range(200):
        picked.update(i for i, _ in draw(seed, 50))
    assert len(picked) == 50          # every frame can be drawn
