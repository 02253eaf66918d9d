"""ht_ms: milliseconds a problem inside the `gep.hessenberg_triangular` call, which the
traced run ends in a synchronize."""

from harness.readers import span_ms


def read(run):
    return span_ms(run, "gep.hessenberg_triangular")
