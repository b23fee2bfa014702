"""Device idle ms a traced frame while the program's ``li.nee`` span (each
``_estimate_direct``: the light pick and sample, the BSDF toward the
light, the shadow ray, whose intersection nests under it) is the innermost
open span of the frame's request: ``li.intersect_idle_ms``'s reading of
another span."""

import harness


def read(readings):
    return harness.reader("metrics", "li.intersect_idle_ms").idle_ms(readings, "li.nee")
