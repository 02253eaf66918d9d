"""backward_error_u: the largest normwise backward error (residual or
orthogonality) over the judged problems, in u = 2^-52."""


def read(run):
    return run.backward_error_u
