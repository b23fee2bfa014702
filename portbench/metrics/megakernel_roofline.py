"""The share of its roofline of the demo's path integration: the least time
of the frame's integrator work (roofline.py) over the device ms of the
operations launched inside ``render.li`` (kernel #1, ``csrc/megakernel.cu``)."""

import roofline

NEEDS_COUNTS = True


def read(readings):
    return roofline.share(readings)
