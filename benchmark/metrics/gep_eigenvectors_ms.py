"""gep_eigenvectors_ms: milliseconds a problem inside the `gep.eigenvectors` call, which the
traced run ends in a synchronize."""

from harness.readers import span_ms


def read(run):
    return span_ms(run, "gep.eigenvectors")
