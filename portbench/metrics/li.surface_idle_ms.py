"""Device idle ms a traced frame while the program's ``li.surface`` span
(the hit's record, emission, bump, footprint, material, subsurface
transport and shading frame) is the innermost open span of the frame's
request: ``li.intersect_idle_ms``'s reading of another span."""

import harness


def read(readings):
    return harness.reader("metrics", "li.intersect_idle_ms").idle_ms(readings, "li.surface")
