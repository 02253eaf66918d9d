"""The port's command-line program (``starneig_tpu_torch.cli``) against the
JAX package's (``starneig_tpu.cli``) at n = 48, for each experiment, SEP
and GEP, on the same seeded known-spectrum input (CPU): both runs pass, and
they report the same hooks, with the same counts (the analysis hook's
zero, infinite and indefinite eigenvalues, the reordering's leading
block) and every gated figure under its fail threshold on both.

The pencils with planted infinite eigenvalues (``--inf-ratio 0.1``, the
mix of the smoke's CLI phase) run without the reordering hook: a random
selection may hold two adjacent infinite eigenvalues, whose swap is
singular and rejected (a partial reordering), and where each package's
QZ leaves them depends on rounding.
"""

import contextlib
import io

import pytest
import torch

from starneig_tpu import cli as jcli
from starneig_tpu_torch import cli as tcli

torch.set_num_threads(1)

EXPERIMENTS = ["hessenberg", "schur", "reorder", "eigenvectors", "full-chain"]
# the hooks gated against a threshold, with the threshold's default
GATED = {"residual_u": 10000.0, "residual_a_u": 10000.0, "residual_b_u": 10000.0,
         "orthogonality_q_u": 10000.0, "orthogonality_z_u": 10000.0,
         "eigenvalue_err_u": 1000000.0, "chordal_eigenvalue_err_u": 1000000.0,
         "reordering_err_u": 10000.0}
COUNTS = ("analysis_zero", "analysis_infinite", "analysis_indefinite",
          "analysis_total", "reordering_selected", "structure_error")


def _run(main, argv):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        res = main(argv)
    return res, out.getvalue()


CASES = ([(e, "sep") for e in EXPERIMENTS] + [(e, "gep") for e in EXPERIMENTS]
         + [(e, "gep-inf") for e in ("schur", "eigenvectors", "full-chain")])


@pytest.mark.parametrize("experiment,problem", CASES)
def test_cli_against_jax(experiment, problem):
    hooks = "residual,orthogonality,structure"
    if experiment != "hessenberg":
        hooks += ",known-eigenvalues,analysis"
        if problem != "gep-inf":
            hooks += ",reordering"
    argv = ["--experiment", experiment, "--n", "48", "--init", "known",
            "--complex-ratio", "0.3", "--hooks", hooks, "--json"]
    if problem != "sep":
        argv += ["--generalized", "--inf-ratio", "0.1" if problem == "gep-inf" else "0"]
    want, _ = _run(jcli.main, argv)
    got, text = _run(tcli.main, argv + ["--device", "cpu"])
    assert want["ok"] and got["ok"]
    assert sorted(got["checks"]) == sorted(want["checks"])
    for k, v in got["checks"].items():
        if k in GATED:
            assert v < GATED[k] and want["checks"][k] < GATED[k], k
        if k in COUNTS:
            assert v == want["checks"][k], k
    if problem == "gep-inf" and experiment != "hessenberg":
        assert got["checks"]["analysis_infinite"] > 0
    assert got["device"] == "cpu" and "EXPERIMENT TIME" in text
    assert "RESIDUAL" in text and text.strip().splitlines()[-1].startswith("{")


def test_cli_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default runs there")
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        tcli.main(["--experiment", "schur", "--n", "8"])
