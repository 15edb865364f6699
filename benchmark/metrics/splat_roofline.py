"""splat_roofline (%, layer: frame export; moves particle_steps_per_s):
the share of its roofline that the frame export's composition on the card
(``csrc/splat.cu``: ``splat_keys_kernel``, ``splat_owners_kernel``,
``splat_shade_kernel``, a frame's projection, draw mask, painter's
composition, shading and 8-bit image) reaches in the traced slice.

The work of one exported frame, whatever implements it.  Bytes: each row
reads its valid and ghost words (whether it is drawn), and a fluid row its
position (where its disc lands and how deep), 20 bytes; the colour is
needed only for the row that owns a pixel, so each pixel reads its
owner's velocity (the speed drive on palette 1 reads nothing else: the
kernels' gather of the owner's other columns serves the other drives and
is not counted), reads the background once and writes the image once, 3
bytes each (with a colour for a background, as the export mixes have,
the pixel's read is counted though none is made: 1.7% of the bytes at 4M
rows).  Operations: 65 a fluid row (the view transform's three FMA chains
and adds 21, the projection's two 7, the perspective divides and pixel
coordinates 10, the draw tests 6, the disc radius 6, the key 1, the
covered pixel's test and truncation 7), 46 a pixel (the shading: the
disc's normal 12, the light's dot product 5, shade and specular 9, colour
and clamp 15, the 8-bit step 5).

    bytes/frame = fluid * (12 + 4 + 4) + ghosts * (4 + 4)
                  + pixels * (12 + 3 + 3)
    ops/frame   = 65 * fluid + 46 * pixels
    roofline = frames * max(bytes / bandwidth, ops / float32 peak)
               / (device seconds of the three kernels in the slice)

``pixels`` is the frame of the mix ``traffic/export16.json``, read from
that file by name: it is the one mix of the cells that list this metric,
and the slice does not carry the frame's size.  A cell of another export
mix needs the size in the slice first (``benchmark/trace.py``), and this
reader to take it from there.
"""
import json
import os

from benchmark import peaks

KERNELS = ("splat_keys_kernel", "splat_owners_kernel", "splat_shade_kernel")
BYTES_PER_FLUID_ROW = 12 + 4 + 4
BYTES_PER_GHOST_ROW = 4 + 4
BYTES_PER_PIXEL = 12 + 3 + 3
OPS_PER_FLUID_ROW = 65
OPS_PER_PIXEL = 46

with open(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "traffic", "export16.json")) as _f:
    _EXPORT = json.load(_f)["export"]
PIXELS = int(_EXPORT["width"]) * int(_EXPORT["height"])


def read(sl):
    hits = [sl.kernel(k) for k in KERNELS]
    seconds = sum(s for s, _ in hits)
    if sum(n for _, n in hits) == 0 or seconds <= 0.0 or not sl.frames:
        return None
    c = sl.counts
    work = (c["fluid"] * BYTES_PER_FLUID_ROW + c["ghosts"] * BYTES_PER_GHOST_ROW
            + PIXELS * BYTES_PER_PIXEL)
    ops = OPS_PER_FLUID_ROW * c["fluid"] + OPS_PER_PIXEL * PIXELS
    return 100.0 * sl.frames * peaks.bound_s(work, ops) / seconds
