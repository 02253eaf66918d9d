"""qz_ms: milliseconds a problem inside the `gep.schur` call, which the
traced run ends in a synchronize."""

from harness.readers import span_ms


def read(run):
    return span_ms(run, "gep.schur")
