"""setup_s: process start to the first timed request (imports, the CUDA
context, loading or building the kernels, the statement, SRS setup, keygen,
the warm-up requests); host clock."""


def read(run):
    return run.setup_s
