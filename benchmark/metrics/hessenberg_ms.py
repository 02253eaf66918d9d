"""hessenberg_ms: milliseconds a problem inside the `sep.hessenberg` call, which the
traced run ends in a synchronize."""

from harness.readers import span_ms


def read(run):
    return span_ms(run, "sep.hessenberg")
