"""The micro-kernels (sph_tpu_torch.app.microbench.smoke,
sph_tpu_torch.app.proto_expand.expand).

CPU: the plain versions against the JAX package's Pallas kernels run in
interpret mode at small sizes: ``scripts/microbench.py``'s ``smoke`` (read
from the script with ``ast``, so that the script's timings do not run) and
``scripts/proto_bfly_kernel.py``'s ``_kernel`` (imported with
``PROTO_NROW``, ``PROTO_S`` and ``PROTO_MAXR`` set small), bit-equal, on
the script's synthetic inputs and on hand-made ones (a row with no
elements, a row whose targets end at slot S - 1); the plain expand
against the script's numpy oracle on the edge cases below.

CUDA (marker ``cuda``, skipped without a card): each kernel against its
plain version, bit-equal, at the scripts' default sizes and at the edge
cases of ``EDGES`` (S not a multiple of 4, S over several chunks, rows
with no elements, a row that fills every slot, one row); the smoke kernel
at [65,536, 512] and at odd element counts:

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


def pack(targets, seed=0, pad=64):
    """starts [len(targets) + 1] int32 and rows [n + pad, WIDTH] float32
    for rows whose elements have the given ascending targets, as the
    script lays them out; the payload is drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    counts = [len(t) for t in targets]
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    rows = np.zeros((int(starts[-1]) + pad, PE.WIDTH), np.float32)
    for y, t in enumerate(targets):
        sl = slice(starts[y], starts[y + 1])
        rows[sl, :PE.F] = rng.standard_normal((len(t), PE.F))
        rows[sl, PE.F] = t
    return starts, rows


def draw(s, count, seed):
    """``count`` ascending unique targets in [0, s)."""
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(s, count, replace=False))


# name -> (each row's targets, S): the expand's edge cases
EDGES = {
    "s_not_multiple_of_4": (
        [draw(4095, 700, 1), np.concatenate([draw(4000, 600, 2), [4094]]),
         draw(4095, 1024, 3)], 4095),
    "several_chunks": (
        [draw(16384, 1024, 4), draw(16384, 3000, 5),
         np.arange(16384 - 700, 16384)], 16384),
    "rows_with_no_elements": (
        [np.array([], np.int64), draw(4096, 900, 6),
         np.array([], np.int64), draw(4096, 513, 7),
         np.array([], np.int64)], 4096),
    "rows_that_fill_slots": (
        [np.arange(4096), np.arange(1024, 3072), np.array([0, 4095]),
         draw(4096, 800, 8)], 4096),
    "one_row": ([draw(4096, 1000, 9)], 4096),
}


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


@pytest.mark.parametrize("case", ["empty_row", "ends_at_last_slot"])
def test_expand_plain_matches_pallas_kernel_hand_made(proto, case):
    """Rows the synthetic inputs never make: one with no elements, one
    whose targets end at slot S - 1 (with one that starts at slot 0)."""
    s, maxr = proto.S, proto.MAXR
    if case == "empty_row":
        targets = [draw(s, 40, 10), np.array([], np.int64),
                   draw(s, maxr, 11), draw(s, 1, 12)]
    else:
        targets = [np.concatenate([draw(s - 1, 30, 13), [s - 1]]),
                   np.arange(s - maxr, s), draw(s, 50, 14),
                   np.concatenate([[0], draw(s - 1, 20, 15) + 1])]
    starts, rows = pack(targets, seed=16, pad=maxr)
    want = jax_expand(proto, starts, rows)
    np.testing.assert_array_equal(want, PE.oracle(starts, rows, targets, s))
    got = PE.expand(torch.as_tensor(starts), torch.as_tensor(rows), s)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", sorted(EDGES))
def test_expand_plain_matches_oracle_at_edges(case):
    targets, s = EDGES[case]
    starts, rows = pack(targets, seed=17)
    got = PE.expand(torch.as_tensor(starts), torch.as_tensor(rows), s)
    np.testing.assert_array_equal(got.numpy(),
                                  PE.oracle(starts, rows, targets, s))


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
    trace.reset()
    MB.smoke(torch.ones(8, 128))
    starts, rows, _ = PE.synth(2, 64, 16)
    PE.expand(torch.as_tensor(starts), torch.as_tensor(rows), 64)
    assert trace.counter("launches.smoke") == 0
    assert trace.counter("launches.expand") == 0
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
@pytest.mark.parametrize("shape", [(256, 512), (65536, 512), (3, 7),
                                   (1000, 33), (257, 3)])
def test_smoke_kernel_matches_plain_on_cuda(cuda, shape):
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(shape)
                        .astype(np.float32), device=cuda)
    trace.reset()
    got = MB.smoke(x)
    torch.cuda.synchronize()
    assert torch.equal(got, MB.smoke_plain(x))
    assert trace.counter("launches.smoke") == 1


@pytest.mark.cuda
@pytest.mark.parametrize("sizes", [(64, 4096, 1024), (4, 256, 64)])
def test_expand_kernel_matches_plain_on_cuda(cuda, sizes):
    nrow, s, maxr = sizes
    starts, rows, targets = PE.synth(nrow, s, maxr)
    st, rw = torch.as_tensor(starts, device=cuda), torch.as_tensor(
        rows, device=cuda)
    trace.reset()
    got = PE.expand(st, rw, s)
    torch.cuda.synchronize()
    assert torch.equal(got, PE.expand_plain(st, rw, s))
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  PE.oracle(starts, rows, targets, s))
    assert trace.counter("launches.expand") == 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(EDGES))
def test_expand_kernel_matches_plain_at_edges_on_cuda(cuda, case):
    targets, s = EDGES[case]
    starts, rows = pack(targets, seed=17)
    st, rw = torch.as_tensor(starts, device=cuda), torch.as_tensor(
        rows, device=cuda)
    trace.reset()
    got = PE.expand(st, rw, s)
    torch.cuda.synchronize()
    assert torch.equal(got, PE.expand_plain(st, rw, s))
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  PE.oracle(starts, rows, targets, s))
    assert trace.counter("launches.expand") == 1


@pytest.mark.cuda
def test_expand_wrapper_refuses_rows_it_cannot_load_as_float4(cuda):
    starts, rows = pack([draw(256, 10, 18)])
    st = torch.as_tensor(starts, device=cuda)
    wide = torch.zeros(rows.shape[0], PE.WIDTH + 2, device=cuda)
    with pytest.raises(ValueError, match="multiple of 4"):
        PE.expand(st, wide, 256)
    flat = torch.zeros(rows.size + 4, device=cuda)
    shifted = flat[1:1 + rows.size].view(rows.shape)
    with pytest.raises(ValueError, match="16-byte"):
        PE.expand(st, shifted, 256)


@pytest.mark.cuda
def test_smoke_wrapper_refuses_x_off_16_bytes(cuda):
    flat = torch.ones(4 * 128 + 4, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        MB.smoke(flat[1:1 + 4 * 128].view(4, 128))
