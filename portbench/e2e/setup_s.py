"""Process start to the first timed frame: imports, loading the kernels
(and in a fresh checkout building them), building the scene and its tree,
and the warm-up frames."""


def read(window) -> float:
    return window.setup_s
