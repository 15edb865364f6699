"""export_png_ms (ms/frame, layer: frame export; moves
particle_steps_per_s): the mean wall time of the harness's ``export.png``
span (``viz.splat.save_png``: zlib at level 6 and the file's write) over
the traced slice's frames."""


def read(sl):
    s = sl.span_seconds("export.png")
    return 1e3 * sum(s) / len(s) if s else None
