"""Device operations (kernels, copies, sets) launched inside the program's
``render.li`` range in a traced frame: the integrator's own, by the same
rule that gives its device ms (devtrace.reduce), from a trace that holds
every launch of the program's kernels.  None where the trace cannot tell
which operations ``render.li`` launched."""


def read(readings):
    counts = [f.li_ops for f in readings.frames]
    if not counts or None in counts:
        return None
    return sum(counts) / len(counts)
