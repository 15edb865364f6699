"""graph_host_ms (ms/frame, layer: frame program; moves
particle_steps_per_s): the host's wall time in the port's span
``sph.graph.run`` (``engine/graph.py``: the frame program's key, copy-in,
replay and clones of the outputs) less what its captures took
(``sph.graph.capture``), summed over the traced slice and divided by its
frames.

    graph_host_ms = 1e3 * (sum(sph.graph.run seconds)
                           - sum(sph.graph.capture seconds)) / frames

None where the slice holds no ``sph.graph.run`` span (the port's spans
off, or a frame that runs eagerly)."""

RUN = "sph.graph.run"
CAPTURE = "sph.graph.capture"


def read(sl):
    run = sl.span_seconds(RUN)
    if not run or not sl.frames:
        return None
    return 1e3 * (sum(run) - sum(sl.span_seconds(CAPTURE))) / sl.frames
