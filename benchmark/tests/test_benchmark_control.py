"""The control of the output check, at a size a test run holds: the
reference computed in the next lower precision (the transforms' matrix
products in TF32, the export in bfloat16) put in the port's place must
come out as not correct under the repo's limits, and the port's own frames
must not.  On the card the control runs at the cells' own sizes
(``python3 -m benchmark.control``)."""
import pytest
import torch

from benchmark import cells, check
from benchmark.run import Run

SEEDS = (2**31 + 5, 2**31 + 6, 2**31 + 7)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("mix", ["sim16", "export16"])
def test_control_is_not_correct(tiny_root, seed, mix):
    cell = cells.load(f"tiny.{mix}", root=tiny_root())
    run = Run(cell, seed, "cpu")
    w = run.window(run.warm_up(), 0.0, 1)
    limits = cell.limits["limits"]
    sound, _ = run.check(w["sample"])
    control, _ = run.check(w["sample"], control=True)
    framed = {k: v for k, v in limits.items() if k in sound}
    assert all(ok for *_, ok in check.verdict(sound, framed))
    out = [k for k, _, _, ok in check.verdict(control, framed) if not ok]
    assert out, control
    if mix == "export16":
        assert control["px_apart"] > limits["px_apart"]


@pytest.mark.cuda
def test_control_is_not_correct_on_the_card(tiny_root):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = cells.load("tiny.sim16", root=tiny_root())
    run = Run(cell, SEEDS[0], "cuda")
    w = run.window(run.warm_up(), 0.0, 1)
    control, _ = run.check(w["sample"], control=True)
    framed = {k: v for k, v in cell.limits["limits"].items()
              if k in control}
    assert not all(ok for *_, ok in check.verdict(control, framed))
