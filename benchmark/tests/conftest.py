"""CPU tests of the benchmark harness: ``python -m pytest benchmark/tests``
from the root of the checkout.  A test that needs a CUDA card carries the
``cuda`` marker and skips, from inside the test, where there is none."""
import json
import os
import shutil
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = dict(fluid_rows=1500, box_half=[2.5, 2.5, 2.5])


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_root(path, config="ghost_1m", limits_of="ghost_1m.sim16",
              **changes) -> str:
    """A checkout root at ``path`` with the repo's benchmark files and one
    more configuration, ``tiny``: ``config``'s file with ``TINY`` and
    ``changes``, in the cells ``tiny.sim16`` and ``tiny.export16``, whose
    limits are those of the repo's cell ``limits_of``."""
    src = os.path.join(ROOT, "benchmark")
    dst = os.path.join(path, "benchmark")
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    with open(os.path.join(src, "configs", f"{config}.json")) as f:
        cfg = json.load(f)
    cfg.update(TINY, name="tiny", **changes)
    with open(os.path.join(dst, "configs", "tiny.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append(dict(bench["configs"][0], name="tiny",
                                 file="benchmark/configs/tiny.json"))
    with open(os.path.join(src, "limits", f"{limits_of}.json")) as f:
        limits = json.load(f)
    with open(os.path.join(src, "limits",
                           "default_131k.export16.json")) as f:
        px = json.load(f)["limits"]["px_apart"]
    for mix in ("sim16", "export16"):
        name = f"tiny.{mix}"
        bench["workloads"].append(dict(name=name, config="tiny", traffic=mix,
                                       chips=1, why="a test's cell"))
        lim = dict(limits, limits=dict(limits["limits"]))
        if mix == "export16":
            lim["limits"]["px_apart"] = px
        with open(os.path.join(dst, "limits", f"{name}.json"), "w") as f:
            json.dump(lim, f)
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return str(path)


@pytest.fixture
def tiny_root(tmp_path):
    """``make_root`` in the test's own directory."""
    return lambda **kw: make_root(tmp_path, **kw)
