"""Material tags.

Counterpart of the tags of ``gopbrt_tpu/ops/bsdf.py``.  The slice's lobes
(Lambert, mirror, FresnelSpecular, GGX R+T rough glass) are evaluated inside
the bounce megakernel (``ops/megakernel.py``).
"""

MATTE = 0
MIRROR = 1
GLASS = 2
PLASTIC = 3
METAL = 4
SUBSURFACE = 5
NULLMAT = 6
