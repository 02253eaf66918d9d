"""setup_s: seconds from the start of the process to the window: the
import, the kernels' build or load, a warm-up problem."""


def read(run):
    return run.setup_s
