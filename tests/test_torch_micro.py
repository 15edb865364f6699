"""The micro-kernels (sph_tpu_torch.app.microbench.smoke,
sph_tpu_torch.app.proto_expand.expand).

CPU: the plain versions against the JAX package's Pallas kernels run in
interpret mode at small sizes: ``scripts/microbench.py``'s ``smoke`` (read
from the script with ``ast``, so that the script's timings do not run) and
``scripts/proto_bfly_kernel.py``'s ``_kernel`` (imported with
``PROTO_NROW``, ``PROTO_S`` and ``PROTO_MAXR`` set small), bit-equal.

CUDA (marker ``cuda``, skipped without a card): each kernel against its
plain version at the scripts' default sizes, bit-equal:

    python -m pytest tests/test_torch_micro.py -q -m cuda --noconftest
"""
import ast
import functools
import importlib.util
import math
import os
import types

import numpy as np
import pytest
import torch

from sph_tpu_torch.app import microbench as MB
from sph_tpu_torch.app import proto_expand as PE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"PROTO_NROW": "4", "PROTO_S": "256", "PROTO_MAXR": "64"}


def jax_smoke():
    """``smoke`` of scripts/microbench.py, read by ``ast`` and run with
    ``pl.pallas_call`` in interpret mode."""
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    path = os.path.join(REPO, "scripts", "microbench.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    keep = [node for node in tree.body if isinstance(node, ast.FunctionDef)
            and node.name in ("smoke_kernel", "smoke")]
    assert len(keep) == 2
    interp = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec, program_id=pl.program_id, when=pl.when)
    ns = {"jnp": jnp, "pl": interp, "pltpu": pltpu, "jax": __import__("jax")}
    exec(compile(ast.Module(body=keep, type_ignores=[]), path, "exec"), ns)
    return ns["smoke"]


@pytest.fixture(scope="module")
def proto(monkeypatch_module):
    """scripts/proto_bfly_kernel.py imported at small sizes; the compile
    cache settings it makes at import are put back."""
    import jax
    for k, v in SMALL.items():
        monkeypatch_module.setenv(k, v)
    keep = {k: getattr(jax.config, k) for k in (
        "jax_compilation_cache_dir",
        "jax_persistent_cache_min_compile_time_secs")}
    spec = importlib.util.spec_from_file_location(
        "proto_bfly_kernel_small",
        os.path.join(REPO, "scripts", "proto_bfly_kernel.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for k, v in keep.items():
        jax.config.update(k, v)
    assert (mod.NROW, mod.S, mod.MAXR) == (4, 256, 64)
    return mod


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def jax_expand(mod, starts, rows):
    """The script's ``pallas_call`` of ``_kernel`` (``:94-108``), in
    interpret mode."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    rounds = int(math.ceil(math.log2(mod.S)))
    out = pl.pallas_call(
        functools.partial(mod._kernel, rounds),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1, grid=(mod.NROW,),
            in_specs=[pl.BlockSpec(memory_space=pltpu.HBM)],
            out_specs=pl.BlockSpec((1, mod.F, mod.S),
                                   lambda y, st: (y, 0, 0),
                                   memory_space=pltpu.VMEM),
            scratch_shapes=[pltpu.VMEM((mod.MAXR, 128), jnp.float32),
                            pltpu.SemaphoreType.DMA]),
        out_shape=jax.ShapeDtypeStruct((mod.NROW, mod.F, mod.S),
                                       jnp.float32),
        interpret=True,
    )(jnp.asarray(starts), jnp.asarray(rows))
    return np.asarray(out)


# ---------------------------------------------------------------------------
# plain versions against the Pallas kernels in interpret mode (CPU)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,seed", [((16, 128), 0), ((64, 256), 1)])
def test_smoke_plain_matches_pallas_kernel(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    # values whose running sum rounds (6x), and -0; no subnormals: XLA on
    # the CPU flushes them to zero
    x[0, :3] = [1.0 + 2.0**-23, 3.0 - 2.0**-22, -0.0]
    want = np.asarray(jax_smoke()(x))
    got = MB.smoke(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, 8.0 * x, rtol=2e-7)
    # the script's own check: 8s from ones
    ones = torch.ones(16, 128)
    assert torch.equal(MB.smoke(ones), torch.full((16, 128), 8.0))


@pytest.mark.parametrize("seed", [0, 5])
def test_expand_plain_matches_pallas_kernel(proto, seed):
    starts, rows, targets = PE.synth(proto.NROW, proto.S, proto.MAXR, seed)
    want = jax_expand(proto, starts, rows)
    np.testing.assert_array_equal(want, PE.oracle(starts, rows, targets,
                                                  proto.S))
    got = PE.expand(torch.as_tensor(starts), torch.as_tensor(rows), proto.S)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got == -1.0).sum() > 0


def test_synth_follows_the_script(proto):
    """The port's inputs and oracle are the script's at the same sizes:
    counts in [MAXR/2, MAXR), ascending unique targets, holes -1."""
    starts, rows, targets = PE.synth(proto.NROW, proto.S, proto.MAXR)
    counts = np.diff(starts)
    assert counts.min() >= proto.MAXR // 2 and counts.max() < proto.MAXR
    for y, t in enumerate(targets):
        assert np.all(np.diff(t) > 0) and t.max() < proto.S
        np.testing.assert_array_equal(rows[starts[y]:starts[y + 1], proto.F],
                                      t)
    ref = PE.oracle(starts, rows, targets, proto.S)
    assert int((ref[:, 0] != -1.0).sum()) == int(starts[-1])


def test_wrappers_on_cpu_take_plain_path_without_counting():
    MB.reset_launches()
    PE.reset_launches()
    MB.smoke(torch.ones(8, 128))
    starts, rows, _ = PE.synth(2, 64, 16)
    PE.expand(torch.as_tensor(starts), torch.as_tensor(rows), 64)
    assert MB.LAUNCHES == {"smoke": 0} and PE.LAUNCHES == {"expand": 0}
    with pytest.raises(ValueError, match="CUDA or CPU"):
        MB.smoke(torch.ones(8, 128, device="meta"))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        PE.expand(torch.as_tensor(starts, device="meta"),
                  torch.as_tensor(rows, device="meta"), 64)


def test_entry_points_need_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        MB.main([])
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        PE.main()


# ---------------------------------------------------------------------------
# kernels against the plain versions (CUDA only)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the micro-kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 512), (3, 7), (1000, 33)])
def test_smoke_kernel_matches_plain_on_cuda(cuda, shape):
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(shape)
                        .astype(np.float32), device=cuda)
    MB.reset_launches()
    got = MB.smoke(x)
    torch.cuda.synchronize()
    assert torch.equal(got, MB.smoke_plain(x))
    assert MB.LAUNCHES == {"smoke": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("sizes", [(64, 4096, 1024), (4, 256, 64)])
def test_expand_kernel_matches_plain_on_cuda(cuda, sizes):
    nrow, s, maxr = sizes
    starts, rows, targets = PE.synth(nrow, s, maxr)
    st, rw = torch.as_tensor(starts, device=cuda), torch.as_tensor(
        rows, device=cuda)
    PE.reset_launches()
    got = PE.expand(st, rw, s)
    torch.cuda.synchronize()
    assert torch.equal(got, PE.expand_plain(st, rw, s))
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  PE.oracle(starts, rows, targets, s))
    assert PE.LAUNCHES == {"expand": 1}
