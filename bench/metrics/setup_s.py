"""End to end: seconds from the start of the run's process to its first
timed request: loading, the CUDA build where it runs, the data, the
store and the edge, and the warm-up."""


def read(run):
    return run.setup_s
