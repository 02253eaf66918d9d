"""launches_per_solve: the change in the program's `kernels.LAUNCHES` over
the window, a problem."""


def read(run):
    return run.launches / run.problems if run.problems and run.launches else None
