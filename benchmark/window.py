"""The statistics of a measured window, and the seeded sample of its
frames that the output check compares."""
from __future__ import annotations

import random
import statistics
from typing import Any, List, Sequence, Tuple


def rate(work_per_frame: float, frames: int, seconds: float) -> float:
    """Work completed per second: ``work_per_frame`` times the frames
    completed, over the seconds from the window's start to the end of its
    last completed frame."""
    if frames < 1 or seconds <= 0.0:
        raise ValueError("a window completes at least one frame")
    return work_per_frame * frames / seconds


def p95(durations: Sequence[float]) -> float:
    """The 95th percentile of every duration, by linear interpolation
    between the closest ranks (``statistics.quantiles``, inclusive)."""
    if len(durations) == 1:
        return float(durations[0])
    return statistics.quantiles(durations, n=100, method="inclusive")[94]


class Reservoir:
    """A uniform sample of ``k`` items of a stream of unknown length,
    drawn by ``random.Random(seed)`` (Algorithm R): the same seed and the
    same number of items give the same sample."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.seen = 0
        self.items: List[Tuple[int, Any]] = []

    def offer(self, item: Any) -> None:
        i = self.seen
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append((i, item))
            return
        j = self.rng.randrange(i + 1)
        if j < self.k:
            self.items[j] = (i, item)

    def sample(self) -> List[Tuple[int, Any]]:
        """(index in the stream, item), in the stream's order."""
        return sorted(self.items, key=lambda t: t[0])
