"""Seconds from the process's start to the window's: imports, the kernels'
build (where the checkout has none), weights and clips made on the card,
the engine, its warm-up and a warm call."""


def read(run):
    return run.setup_s
