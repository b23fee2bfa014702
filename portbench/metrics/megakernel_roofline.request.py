"""The share of its roofline of the service request's path integration: the
least time of the request's integrator work (roofline.py; the reference's
events on the demo's 16 passes of 1920x1080 at path depth 10) over the
device ms of the operations launched inside ``render.li`` (kernel #1,
``csrc/megakernel.cu``)."""

import roofline

NEEDS_COUNTS = True


def read(readings):
    return roofline.share(readings)
