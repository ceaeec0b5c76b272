"""Process start to the first timed call: imports, the build or load of the
kernels, weights and inputs drawn, the checks' first steps and the warm-up."""


def read(run):
    return run.setup_s
