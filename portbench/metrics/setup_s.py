"""Seconds from the start of the run's process to the first timed item:
imports, CUDA's start, loading (or building) the kernels, the inputs,
the warm-up and, in a traced run, starting the profiler."""


def read(r):
    return r.setup_s
