"""Host ms a traced frame of the program's ``render.splat`` range: the row
splat of every band (``models/film.add_samples_rows``)."""


def read(readings):
    return sum(f.host_ms["render.splat"] for f in readings.frames) / len(readings.frames)
