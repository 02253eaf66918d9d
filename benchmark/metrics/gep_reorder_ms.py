"""gep_reorder_ms: milliseconds a problem inside the `gep.reorder_schur` call, which the
traced run ends in a synchronize."""

from harness.readers import span_ms


def read(run):
    return span_ms(run, "gep.reorder_schur")
