"""100 x (1 - the device's busy ms of a traced frame / the median host ms of
the window's untraced frames): the share of a frame in which the card has
no operation to run."""

import statistics


def read(readings):
    busy = sum(f.busy_ms for f in readings.frames) / len(readings.frames)
    frame_ms = [(b - a) * 1e3 for a, b in readings.window.frames]
    return 100.0 * (1.0 - busy / statistics.median(frame_ms))
