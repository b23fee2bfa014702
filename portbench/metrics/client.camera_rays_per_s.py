"""The end-to-end ``camera_rays_per_s``, by the same arithmetic over the
same untraced window, in the cells whose runs spread too widely to hold the
rate to a bound and whose end-to-end metric is the frames' tail
(``frame_ms_p95``)."""

import harness


def read(readings):
    return harness.reader("e2e", "camera_rays_per_s").read(readings.window)
