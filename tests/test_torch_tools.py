"""The port's tools (trace, sanity checks, the multi-rank dry run) and
examples, against the JAX package's, on the CPU.

* sanity: each check on the same good and bad inputs through both
  packages (the port's with numpy arrays and with torch tensors): the
  port raises ``SanityError`` exactly where the JAX package does, and
  each case raises or passes as it was built to;
* trace: the same spans through both packages give the same events
  (labels, rects, extra keys; times ordered) under the renderer's schema
  (``native/trace_render.cpp:13-14``), and ``dump_trace`` round-trips;
* the dry run (2 CPU ranks, n=128) and the three examples run as child
  processes with ``--device cpu``, all four started at once, exit 0 and
  print the JAX package's lines.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.linalg
import torch

import starneig_tpu.tools as jtools
from starneig_tpu.tools import sanity as jsanity
from starneig_tpu.tools import trace as jtrace

import starneig_tpu_torch.tools as ttools
from starneig_tpu_torch.tools import sanity as tsanity
from starneig_tpu_torch.tools import trace as ttrace

ROOT = Path(__file__).resolve().parents[1]
CHILD_TIMEOUT_S = 600

torch.set_num_threads(1)


def _sanity_cases():
    """{(check, case): (args, raises)}: the inputs and whether they are
    built to fail the check."""
    rng = np.random.default_rng(3)
    n = 24
    H = np.triu(rng.standard_normal((n, n)), -1)
    Hbad = H.copy()
    Hbad[9, 2] = 1e-30                       # one nonzero below the subdiagonal
    Hnan = H.copy()
    Hnan[7, 1] = np.nan
    A = rng.standard_normal((n, n))
    S, Q = scipy.linalg.schur(A, output="real")
    Sover = np.triu(rng.standard_normal((n, n)))
    Sover[6, 5] = Sover[7, 6] = 0.5          # subdiagonals at 5 and 6: overlapping blocks
    Sinf = S.copy()
    Sinf[0, 3] = np.inf
    E = rng.standard_normal((n, n))
    cases = {
        ("check_hessenberg", "upper_hessenberg"): ((H,), False),
        ("check_hessenberg", "below_subdiagonal"): ((Hbad,), True),
        ("check_hessenberg", "nan_below_subdiagonal"): ((Hnan,), True),
        ("check_hessenberg", "two_by_two"): ((A[:2, :2],), False),
        ("check_schur_form", "real_schur"): ((S,), False),
        ("check_schur_form", "overlapping_blocks"): ((Sover,), True),
        ("check_schur_form", "below_subdiagonal"): ((Hbad,), True),
        ("check_finite", "finite"): ((A,), False),
        ("check_finite", "nan"): ((Hnan,), True),
        ("check_finite", "inf"): ((Sinf,), True),
        ("check_orthogonality", "orthogonal"): ((Q,), False),
        ("check_orthogonality", "near_orthogonal"): ((Q + 1e-13 * E,), False),
        ("check_orthogonality", "not_orthogonal"): ((Q + 1e-8 * E,), True),
        ("check_residual_bracket", "schur_pair"): ((A, S, Q), False),
        ("check_residual_bracket", "perturbed_S"): ((A, S + 1e-6 * E, Q), True),
    }
    return cases


SANITY = _sanity_cases()


def _raises(fn, *args):
    try:
        fn(*args)
    except AssertionError as exc:
        return type(exc).__name__
    return None


@pytest.fixture
def sanity_on():
    jsanity.enable_sanity_checks(True)
    tsanity.enable_sanity_checks(True)
    try:
        yield
    finally:
        jsanity.enable_sanity_checks(False)
        tsanity.enable_sanity_checks(False)


@pytest.mark.parametrize("check,case", list(SANITY), ids=[f"{c}-{k}" for c, k in SANITY])
def test_sanity_raises_where_jax_does(sanity_on, check, case):
    args, raises = SANITY[(check, case)]
    want = _raises(getattr(jsanity, check), *args)
    got_np = _raises(getattr(tsanity, check), *args)
    got_t = _raises(getattr(tsanity, check), *(torch.tensor(a) for a in args))
    assert got_np == got_t == want == ("SanityError" if raises else None)


def test_sanity_off_raises_nothing():
    tsanity.enable_sanity_checks(False)
    assert not tsanity.sanity_enabled()
    for (check, _case), (args, _raises_) in SANITY.items():
        getattr(tsanity, check)(*args)


def test_tools_exports():
    """The port's tools package exports every name the JAX package's does."""
    names = [k for k, v in vars(jtools).items()
             if not k.startswith("_") and callable(v)]
    assert len(names) == 12
    for k in names:
        assert callable(getattr(ttools, k)), k


def _record(trace):
    """The same spans and events through either package's trace module."""
    trace.enable_tracing()
    with trace.trace_span("hessenberg", (0, 0, 64, 64), panel=3):
        pass
    with trace.trace_span("schur"):
        pass
    with pytest.raises(ValueError):
        with trace.trace_span("failed", (8, 8, 16, 16)):
            raise ValueError("recorded all the same")
    trace.trace_event("window", 1.0e9, 1.0e9 + 0.5, (10, 12, 4, 4), round=2, kind="aed")
    trace.disable_tracing()
    trace.trace_event("off", 0.0, 1.0)        # not recorded
    with trace.trace_span("off"):
        pass
    return trace.tracing_enabled()


def test_trace_matches_jax(tmp_path):
    assert not _record(jtrace) and not _record(ttrace)
    mine = json.loads(Path(ttrace.dump_trace(str(tmp_path / "t.json"), n=64)).read_text())
    theirs = json.loads(Path(jtrace.dump_trace(str(tmp_path / "j.json"), n=64)).read_text())
    assert set(mine) == {"n", "events"} and mine["n"] == 64
    strip = lambda evs: [{k: v for k, v in e.items() if k not in ("begin", "end")}  # noqa: E731
                         for e in evs]
    assert strip(mine["events"]) == strip(theirs["events"])
    assert [e["label"] for e in mine["events"]] == ["hessenberg", "schur", "failed", "window"]
    for e in mine["events"]:
        assert {"label", "begin", "end", "rect"} <= set(e)
        assert e["begin"] <= e["end"]
        assert e["rect"] is None or (len(e["rect"]) == 4
                                     and all(isinstance(x, int) for x in e["rect"]))


def test_dump_trace_round_trips(tmp_path):
    ttrace.enable_tracing()
    with ttrace.trace_span("reorder", (4, 4, 8, 8), windows=2):
        pass
    path = ttrace.dump_trace(str(tmp_path / "trace.json"), n=16)
    ttrace.disable_tracing()
    got = json.loads(Path(path).read_text())
    assert got == {"n": 16, "events": ttrace._EVENTS}
    assert got["events"][0]["rect"] == [4, 4, 8, 8] and got["events"][0]["windows"] == 2


# the children: (module, size); each prints the JAX counterpart's lines
CHILDREN = {
    "sep_full_chain": ("starneig_tpu_torch.examples.sep_full_chain", 96),
    "gep_full_chain": ("starneig_tpu_torch.examples.gep_full_chain", 48),
    "distributed": ("starneig_tpu_torch.examples.distributed", 96),
    "dryrun": ("starneig_tpu_torch.tools.dryrun", 2),
}
NUM = r"\s*[0-9.]+"
EXPECT = {
    "sep_full_chain": [r"info = 0, selected \(positive real part\) = \d+",
                       rf"residual      ={NUM} u", rf"orthogonality ={NUM} u",
                       r"eigenvectors: \(96, \d+\)"],
    "gep_full_chain": [r"info = 0, selected = \d+", rf"residual A    ={NUM} u",
                       rf"residual B    ={NUM} u", rf"orthogonality ={NUM} u",
                       r"infinite eigenvalues: 0", r"generalized eigenvectors: \(48, \d+\)"],
    "distributed": [r"mesh: 2 ranks", r"info = 0", rf"residual ={NUM} u",
                    r"reordered \d+ rows to the top \(info = 0\)"],
    "dryrun": [r"dryrun_multichip\(2\): full chain ok, residual \d+u orth \d+u nsel=\d+"],
}


@pytest.fixture(scope="module")
def children():
    """Every child started at once: {name: Popen}."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), STARNEIG_DRYRUN_N="128",
               OMP_NUM_THREADS="1")
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", mod, str(n), "--device", "cpu"], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, (mod, n) in CHILDREN.items()}
    try:
        yield procs
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
            p.communicate()


@pytest.mark.parametrize("name", list(CHILDREN))
def test_child_runs_on_cpu(children, name):
    out, err = children[name].communicate(timeout=CHILD_TIMEOUT_S)
    assert children[name].returncode == 0, err[-4000:]
    lines = out.strip().splitlines()
    assert len(lines) == len(EXPECT[name]), out
    for line, pat in zip(lines, EXPECT[name]):
        assert re.fullmatch(pat, line), (line, pat)
    for m in re.finditer(r"(residual[^=]*|orthogonality) =\s*([0-9.]+) u", out):
        assert float(m.group(2)) < 500, m.group(0)
