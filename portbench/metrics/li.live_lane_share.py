"""100 x the lanes alive entering the chain's bounces over the lanes its
bounces run over, in the traced frames' requests: the program's counters
``li.lanes_live`` and ``li.lanes_run`` (``li_direct`` with its final
emission pass, ``_li_wavefront``, ``_li_compacted``), summed over every
bounce of every band.  The rest of the chain's work runs on dead lanes.
None where the program keeps no such counts."""

import harness


def read(readings):
    reqs = harness.reader("metrics", "render.host_syncs").requests(readings)
    if reqs is None:
        return None
    run = sum(r.total("li.lanes_run") for r in reqs)
    return 100.0 * sum(r.total("li.lanes_live") for r in reqs) / run if run else None
