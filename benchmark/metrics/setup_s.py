"""End to end: seconds from the process's start to the window's first
step: the kernel library, the scene, the weights, the pipeline and its
style targets, and the first three steps (host clock)."""


def read(record):
    return record.setup_s
