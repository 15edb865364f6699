"""export_render_ms (ms/frame, layer: frame export; moves
particle_steps_per_s): the mean wall time of the harness's
``export.render`` span (``viz.splat.render_frame``: colours on the card,
projection, sort and splat on the host) over the traced slice's frames."""


def read(sl):
    s = sl.span_seconds("export.render")
    return 1e3 * sum(s) / len(s) if s else None
