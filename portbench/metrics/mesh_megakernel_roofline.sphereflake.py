"""The share of its roofline of the sphereflake's path integration: the
least time of the frame's integrator work on the reference's tree
(roofline.py; the reference's events on 7,381 sphere leaves) over the
device ms of the operations launched inside ``render.li`` (kernel #5,
``csrc/mesh_megakernel.cu``)."""

import roofline

NEEDS_COUNTS = True


def read(readings):
    return roofline.share(readings)
