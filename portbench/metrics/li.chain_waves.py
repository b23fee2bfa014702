"""Waves a traced frame that ``integrators.li`` sent to the torch chain:
the ``chain`` count of the program's counter ``li.route`` (one count a
``li`` call, keyed ``brute_megakernel``, ``bvh_megakernel`` or ``chain``)
in the frame's request, as ``render.host_syncs`` takes it.  0 where every
wave ran on a megakernel; None where the program keeps no such counter."""

import harness


def read(readings):
    reqs = harness.reader("metrics", "render.host_syncs").requests(readings)
    if reqs is None:
        return None
    routes = [r.counter("li.route") for r in reqs]
    if not any(routes):
        return None
    return sum(r.get("chain", 0) for r in routes) / len(routes)
