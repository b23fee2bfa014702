"""Host ms a traced frame of the program's ``render.band_rays`` range: the
camera rays of every band (counter RNG, ``models/render.band_rays``)."""


def read(readings):
    return sum(f.host_ms["render.band_rays"] for f in readings.frames) / len(readings.frames)
