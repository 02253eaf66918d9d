"""The port's blocked Hessenberg reduction against the JAX package's XLA
path, on the same seeded matrices (CPU, float64).

Tolerances: one panel elementwise to 1e-12 (a few dozen dependent
matrix-vector products); a whole reduction elementwise to 1e-11 ||A||
(the trailing GEMMs sum in another order than XLA's).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starneig_tpu.config import HessenbergConf as JConf
from starneig_tpu.ops import hessenberg as jhess
from starneig_tpu_torch.convert import conf_from_jax, from_numpy, to_numpy
from starneig_tpu_torch.ops import hessenberg as thess

torch.set_num_threads(1)


@pytest.mark.parametrize("k,t0", [(0, 0), (16, 8)])
def test_panel(k, t0):
    n, nb = 64, 16
    A = np.random.default_rng(k).standard_normal((n, n))
    want = jhess._panel(jnp.asarray(A), k, nb, t0, jnp.int32(n))
    got = thess._panel(from_numpy(A), k, nb, t0, n)
    for name, g, w in zip("VTYP", got, want):
        np.testing.assert_allclose(to_numpy(g), np.asarray(w), rtol=0,
                                   atol=1e-12, err_msg=name)


@pytest.mark.parametrize("end", [None, 90])
def test_hessenberg(end):
    n = 150
    A = np.random.default_rng(7).standard_normal((n, n))
    conf = JConf(panel_width=16)          # several panels and t0 buckets
    Hj, Qj = map(np.asarray, jhess.hessenberg(jnp.asarray(A), conf=conf,
                                              end=end))
    Ht, Qt = map(to_numpy, thess.hessenberg(from_numpy(A),
                                            conf=conf_from_jax(conf), end=end))
    na = np.linalg.norm(A)
    np.testing.assert_allclose(Ht, Hj, rtol=0, atol=1e-11 * na)
    np.testing.assert_allclose(Qt, Qj, rtol=0, atol=1e-11)
    # exact structure of the reduced columns, and a similarity
    lim = n if end is None else end - 2
    assert np.abs(np.tril(Ht[:, :lim], -2)).max() == 0.0
    u = np.finfo(np.float64).eps / 2
    assert np.linalg.norm(Qt @ Ht @ Qt.T - A) / na / u < 500


def test_hessenberg_begin_and_initial_q():
    # a partial range [begin, end) on a matrix already reduced in its
    # leading columns, accumulated onto a given Q
    n = 96
    rng = np.random.default_rng(3)
    A = rng.standard_normal((n, n))
    A[20:, :19] = 0.0                     # Hessenberg in columns < begin
    Q0, _ = np.linalg.qr(rng.standard_normal((n, n)))
    conf = JConf(panel_width=16)
    Hj, Qj = map(np.asarray, jhess.hessenberg(
        jnp.asarray(A), jnp.asarray(Q0), conf=conf, begin=19, end=80))
    Ht, Qt = map(to_numpy, thess.hessenberg(
        from_numpy(A), from_numpy(Q0), conf=conf_from_jax(conf), begin=19,
        end=80))
    np.testing.assert_allclose(Ht, Hj, rtol=0, atol=1e-11 * np.linalg.norm(A))
    np.testing.assert_allclose(Qt, Qj, rtol=0, atol=1e-11)
