"""The frame export's composition on the card (``csrc/splat.cu``, the
device path of ``viz/splat.render_frame``) and its plain torch version
(:func:`compose_plain`, the card's rule written once more).

On the CPU: the plain composition (each covered pixel takes the largest
key of view depth, row and footprint offset, by ``scatter_reduce`` amax,
then is shaded from that owner) is held bit for bit, image and depth
buffer, to the host rasterizer ``splat_raster`` on seeded rows with
overlapping discs, exact ties in depth and discs cut by x = 0 and y = 0,
lit and flat, over a colour and over an image; and ``render_frame_keyed``
(the host's projection, then the plain composition) to ``render_frame`` on
spawned states with a ``mask``, a terrain background and
``return_depth``.

CUDA (marker ``cuda``, skipped without a card): ``render_frame`` on a CUDA
state composes on the card, with two ``launches.splat`` and one
``host_waits`` a frame, the same frame three times in a row, and gives
the host path's frame of the same state (``render_frame_host``, its
colours from the card) with 0 pixels and 0
depth-buffer entries apart, at 4,096 and 65,536 rows, plain and with a
mask and a terrain image; against the same state on the CPU the colours
themselves may differ in the last bit (torch's CUDA and CPU sums over a
row's three speed components add in another order), so a pixel may sit
one level apart there, and the share of such pixels is bounded by
``CPU_APART``.  Built with the port alone:

    python -m pytest tests/test_torch_splat_card.py -q -m cuda --noconftest
"""
import numpy as np
import pytest
import torch

from sph_tpu_torch.core import state as S
from sph_tpu_torch.native import build
from sph_tpu_torch.utils import trace
from sph_tpu_torch.viz import palettes as P
from sph_tpu_torch.viz import splat
from sph_tpu_torch.viz.camera import fit_camera

W, H = 160, 90
# the share of pixels more than one level apart between the card's frame
# and the CPU state's (colours that differ in their last bit round to the
# next level at most)
CPU_APART = 0.0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU ops on one thread while this module runs: the suite
    runs in several processes at once, where each process's pool of torch
    threads spins against the others'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(seed: int, m: int = 3000):
    """Seeded drawn rows of a W x H frame, in row order: centres over the
    frame and past its edges, a fifth of them within a pixel of x = 0 or
    y = 0 (where int(cx + dx) truncates toward zero, so two offsets of one
    disc land on one pixel), radii over [0.5, 4], view depths from eight
    values (exact ties), colours in [0, 1]."""
    rng = np.random.default_rng(seed)
    cx = rng.uniform(-8, W + 8, m).astype(np.float32)
    cy = rng.uniform(-8, H + 8, m).astype(np.float32)
    edge = rng.random(m) < 0.2
    cx[edge] = rng.uniform(-1, 1, int(edge.sum())).astype(np.float32)
    cy[edge[::-1]] = rng.uniform(-1, 1, int(edge.sum())).astype(np.float32)
    rad = rng.uniform(0.5, 4.0, m).astype(np.float32)
    depth = rng.choice(np.float32([20.0, 20.5, 21.0, 22.25, 23.0, 24.5,
                                   30.0, 31.0]), m)
    col = rng.uniform(0, 1, (m, 3)).astype(np.float32)
    idx = np.sort(rng.choice(4 * m, m, replace=False))
    light = np.float32([0.3, 0.8, 0.52])
    return idx, cx, cy, rad, col, light, depth


def _raster(img, rows, lit, sun):
    """The host rasterizer over the rows painter-sorted, as
    ``render_frame_host`` calls it."""
    idx, cx, cy, rad, col, light, depth = rows
    order = np.argsort(-depth, kind="stable")
    args = [np.ascontiguousarray(a, np.float32)
            for a in (cx[order], cy[order], rad[order], col[order], light,
                      sun, depth[order])]
    buf = np.ascontiguousarray(img, np.float32).copy()
    zbuf = np.zeros(W * H, np.float32)
    ptr = [a.ctypes.data for a in args]
    build.splat_library().splat_raster(
        len(cx), ptr[0], ptr[1], ptr[2], ptr[3], W, H, buf.ctypes.data,
        int(lit), ptr[4], ptr[5], 4, ptr[6], zbuf.ctypes.data)
    return splat._finish(buf, W, H, zbuf, True)


def _pow24(x: torch.Tensor) -> torch.Tensor:
    """x^24 in float64 by squaring, rounded once to float32, as
    ``csrc/splat.cu`` takes it."""
    x2 = x.double() * x.double()
    x4 = x2 * x2
    x8 = x4 * x4
    return ((x8 * x8) * x8).float()


def compose_plain(img: np.ndarray, rows, lit: bool, sun_color,
                  width: int, height: int, max_footprint: int = 4):
    """Plain torch version of the card's composition (``csrc/splat.cu``)
    on the host's drawn rows (``rows`` as ``splat._drawn`` gives them, in
    row order, or None) over the background ``img`` [H*W, 3] float32:
    each covered pixel takes the largest key (view depth, row, footprint
    offset) of the writes that land on it (``scatter_reduce`` amax), then
    is shaded from that owner.  Returns the [H*W, 3] float32 image and the
    [H*W] depth buffer."""
    img = torch.from_numpy(np.array(img, np.float32).reshape(-1, 3))
    zbuf = torch.zeros(width * height, dtype=torch.float32)
    if rows is None:
        return img, zbuf
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    row, cx, cy, rad, col, light, depth = (
        t(rows[0]).long(), t(rows[1]), t(rows[2]), t(rows[3]), t(rows[4]),
        t(np.asarray(rows[5], np.float32)), t(rows[6]))
    fp, shift = int(max_footprint), splat._row_shift(max_footprint)
    side = 2 * fp + 1
    top = (0x7FFFFFFF - depth.view(torch.int32).long()) << 32
    base = top | (row << shift)
    keys = torch.zeros(width * height, dtype=torch.int64)
    for dy in range(-fp, fp + 1):
        for dx in range(-fp, fp + 1):
            d = torch.sqrt(torch.tensor(float(dx * dx + dy * dy)))
            sel = d <= rad
            x = (cx[sel] + float(dx)).to(torch.int32)
            y = (cy[sel] + float(dy)).to(torch.int32)
            inb = (x >= 0) & (x < width) & (y >= 0) & (y < height)
            pix = y[inb].long() * width + x[inb].long()
            f = (dy + fp) * side + dx + fp
            keys.scatter_reduce_(0, pix, base[sel][inb] | f, "amax")
    covered = keys != 0
    key = keys[covered]
    j = torch.searchsorted(row, (key & 0xFFFFFFFF) >> shift)
    rgb = col[j]
    if lit:
        f = key & ((1 << shift) - 1)
        dx, dy = f % side - fp, f // side - fp
        d = torch.sqrt((dx * dx + dy * dy).float())
        r = rad[j]
        rc = torch.where(r < 0.5, 0.5, r)
        nr = d / rc
        nr = torch.where(nr > 0.97, 0.97, nr)
        nz = torch.sqrt(1.0 - nr * nr)
        dd = torch.where(d < 1e-6, 1e-6, d)
        nx = (dx.float() / dd) * nr
        ny = ((-dy).float() / dd) * nr
        diff = (nx * light[0] + ny * light[1]) + nz * light[2]
        diff = torch.where(diff < 0.0, 0.0, diff)
        shade = 0.35 + 0.65 * diff
        spec = _pow24(diff) * 0.4
        sun = torch.tensor(np.asarray(sun_color, np.float32))
        rgb = rgb * shade[:, None] + sun * spec[:, None]
        rgb = torch.where(rgb > 1.0, 1.0, rgb)
        rgb = torch.where(rgb < 0.0, 0.0, rgb)
    img[covered] = rgb
    zbuf[covered] = depth[j]
    return img, zbuf


def render_frame_keyed(state, vp: P.VizParams, cam, width=960, height=540,
                       particle_radius=0.12, background=(0.03, 0.04, 0.06),
                       max_footprint=4, mask=None, return_depth=False):
    """``splat.render_frame`` with the host's projection and
    :func:`compose_plain`, the card's composition in plain torch, in place
    of the sort and the host rasterizer."""
    img, rows = splat._drawn(state, vp, cam, width, height,
                             particle_radius, background, max_footprint,
                             mask)
    img, zbuf = compose_plain(img, rows, vp.lit_sphere, vp.sun_color, width,
                              height, max_footprint)
    return splat._finish(img.numpy(), width, height, zbuf.numpy(),
                         return_depth)


@pytest.mark.parametrize("lit", [True, False])
@pytest.mark.parametrize("image", [False, True])
def test_compose_plain_is_the_rasterizer_bit_for_bit(lit, image):
    rows = _rows(7 + 2 * lit + image)
    rng = np.random.default_rng(3)
    if image:
        img = rng.integers(0, 256, (W * H, 3)).astype(np.float32) / 255.0
    else:
        img = np.broadcast_to(np.float32([0.03, 0.04, 0.06]),
                              (W * H, 3)).copy()
    sun = np.float32([1.0, 0.96, 0.9])
    want, want_z = _raster(img, rows, lit, sun)
    got, got_z = compose_plain(img, rows, lit, sun, W, H)
    got, got_z = splat._finish(got.numpy(), W, H, got_z.numpy(), True)
    assert np.array_equal(got, want)
    assert np.array_equal(got_z.view(np.int32), want_z.view(np.int32))
    # the inputs reach every rule of the key: ties in depth that share a
    # pixel, and offsets of one disc truncated onto one pixel
    assert (want_z > 0).mean() > 0.5
    _, cx, cy, rad, *_ = rows
    assert ((np.abs(cx) < 1) & (rad >= 1)).sum() > 10


def _state(n: int, half: float, seed: int, device):
    """A spawned box of ``n`` rows with seeded velocities (speeds over the
    palette's range) on ``device``."""
    sp = S.spawn_standard(n, h=0.28, box_half=(half, half, half), seed=seed)
    st = S.state_from_spawn(sp, device=device)
    rng = np.random.default_rng(seed)
    vel = rng.normal(0, 4, (st.n, 3)).astype(np.float32)
    return st.replace(vel=torch.from_numpy(vel).to(device))


def _export(half):
    vp = P.VizParams(palette_id=1, color_drive=P.DRIVE_SPEED,
                     height_min=-half, height_max=half)
    return vp, fit_camera(np.float32([half, half, half]), margin=1.2)


def _terrain(width, height, seed=5):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (height, width, 3)).astype(np.uint8)


@pytest.mark.parametrize("extras", ["plain", "mask_terrain_depth"])
def test_render_frame_keyed_is_render_frame(extras):
    st = _state(3000, 3.0, 11, "cpu")
    vp, cam = _export(3.0)
    kw = dict(width=W, height=H, particle_radius=0.3)
    if extras != "plain":
        rng = np.random.default_rng(2)
        kw.update(mask=rng.random(st.n) < 0.6, background=_terrain(W, H),
                  return_depth=True)
    want = splat.render_frame(st, vp, cam, **kw)
    got = render_frame_keyed(st, vp, cam, **kw)
    if extras == "plain":
        assert np.array_equal(got, want)
        assert (want != want[0, 0]).any(axis=-1).mean() > 0.05
    else:
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1].view(np.int32), want[1].view(np.int32))
        assert (want[1] > 0).mean() > 0.03


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n, half", [(4096, 3.0), (65536, 7.5)])
@pytest.mark.parametrize("extras", ["plain", "mask_terrain_depth"])
def test_card_frame_is_the_host_frame(cuda, n, half, extras):
    st = _state(n, half, 23, cuda)
    vp, cam = _export(half)
    kw = dict(width=960, height=540, particle_radius=0.14)
    if extras != "plain":
        rng = np.random.default_rng(4)
        kw.update(mask=rng.random(st.n) < 0.6,
                  background=_terrain(960, 540), return_depth=True)
    frames = []
    for _ in range(3):
        before = trace.counters()
        frames.append(splat.render_frame(st, vp, cam, **kw))
        moved = {k: v - before.get(k, 0)
                 for k, v in trace.counters().items()}
        assert moved.get("launches.splat") == 2
        assert moved.get("host_waits") == 1
    for later in frames[1:]:
        for a, b in zip(later if extras != "plain" else [later],
                        frames[0] if extras != "plain" else [frames[0]]):
            assert np.array_equal(a, b)
    got = frames[-1]
    want = splat.render_frame_host(st, vp, cam, **kw)
    if extras != "plain":
        (got, got_z), (want, want_z) = got, want
        assert int((got_z.view(np.int32) != want_z.view(np.int32)).sum()) == 0
    assert int((got != want).any(axis=-1).sum()) == 0
    assert (want != want[0, 0]).any(axis=-1).mean() > 0.05
    on_cpu = splat.render_frame(_state(n, half, 23, "cpu"), vp, cam, **kw)
    on_cpu = on_cpu[0] if extras != "plain" else on_cpu
    d = np.abs(got.astype(np.int16) - on_cpu.astype(np.int16)).max(axis=-1)
    print(f"card vs CPU state: {int((d > 0).sum())} pixels apart, "
          f"{int((d > 1).sum())} by more than one level")
    assert (d > 1).mean() <= CPU_APART
