"""Seconds from process start to the first timed call: imports, CUDA,
inputs made from the seed, the program's set-up and the warm-up calls."""


def read(run):
    return run.setup_s
