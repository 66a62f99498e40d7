"""Video frames embedded a second: the frames of every clip that the
window's calls returned (a clip returned as None adds none), over the
window's host seconds, from its start to the end of the last call it
started."""


def read(run):
    return run.frames / run.window_s if run.window_s > 0 else None
