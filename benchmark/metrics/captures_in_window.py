"""captures_in_window (captures, layer: frame program; moves
particle_steps_per_s): the frame programs that the port captured during
the measured window, its counter ``graph.captures`` as it moved from the
window's first frame to the end of its last, traced frames and untraced
alike.  The warm-up captures every shape the cell uses, so a sound run
reads 0; a capture in the window is compile work inside the measured
time.

    captures_in_window = delta(graph.captures) over the window

None where the slice holds no window counters (the port's were not
read)."""

COUNTER = "graph.captures"


def read(sl):
    if sl.window_counters is None:
        return None
    return sl.window_counters.get(COUNTER, 0)
