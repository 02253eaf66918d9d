"""Auxiliary tooling: event tracing, numerical sanity checks and the
multi-rank dry run (``starneig_tpu/tools`` and ``__graft_entry__.py``'s
``dryrun_multichip`` in the JAX package)."""

from starneig_tpu_torch.tools.trace import (
    tracing_enabled,
    enable_tracing,
    disable_tracing,
    trace_event,
    trace_span,
    dump_trace,
    events_ns,
)
from starneig_tpu_torch.tools.sanity import (
    sanity_enabled,
    enable_sanity_checks,
    check_hessenberg,
    check_schur_form,
    check_orthogonality,
    check_finite,
)
