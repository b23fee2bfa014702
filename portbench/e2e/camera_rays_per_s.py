"""Camera rays (pixels x samples) of every frame of the window, over the
time from the window's start to the end of its last frame."""


def read(window) -> float:
    elapsed = window.frames[-1][1] - window.start
    return window.rays_per_frame * len(window.frames) / elapsed
