"""The benchmark's inputs, made on the device from a seed.

Plain torch, importing nothing of the program.  Each generator takes a
configuration (the dict of ``configs/<name>.json``), a seed and a device,
and returns the problem's input tensors in float64.  The same seed on the
same device gives the same tensors bit for bit.

``random_dense`` is the StarNEig test driver's ``random`` initializer: a
dense matrix of standard normal entries.  ``known_spectrum_pencil`` is a
frozen copy of the construction of StarNEig's ``known`` initializer as the
repository's ``testing.generators.known_spectrum_pencil`` builds it: a
generalized Schur pair with planted complex pairs (``complex_ratio``)
and infinite eigenvalues (``inf_ratio``), scrambled by two random
orthogonal matrices.  Here every random number is drawn on
the device in a few large calls; only the block pattern (which positions
start a pair) is walked on the host, from n uniform numbers.
"""

from __future__ import annotations

import math

import numpy as np
import torch

F64 = torch.float64
_MASK63 = (1 << 63) - 1


def problem_seed(seed: int, k: int) -> int:
    """The seed of problem k of a run seeded with ``seed`` (k = -1 for the
    warm-up problem): distinct for every (seed, k), any seed up to 2**63."""
    return (int(seed) * 1_000_003 + 7919 * (int(k) + 2)) & _MASK63


def _gen(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(seed)
    return g


def random_dense(conf: dict, seed: int, device) -> dict:
    n = int(conf["n"])
    g = _gen(seed, device)
    return {"A": torch.randn(n, n, generator=g, dtype=F64, device=device)}


def random_orthogonal(n: int, g: torch.Generator, device) -> torch.Tensor:
    """The Q factor of a Gaussian matrix, its columns signed so that R's
    diagonal is positive (Haar distributed)."""
    q, r = torch.linalg.qr(torch.randn(n, n, generator=g, dtype=F64, device=device))
    return q * torch.sign(torch.diagonal(r))


def block_pattern(u: np.ndarray, complex_ratio: float) -> np.ndarray:
    """Which positions start a 2x2 block: position i starts one when it is
    not the second row of the block above, i + 1 < n and u[i] <
    complex_ratio (the generator's sequential rule)."""
    n = len(u)
    start = np.zeros(n, bool)
    i = 0
    while i < n:
        if i + 1 < n and u[i] < complex_ratio:
            start[i] = True
            i += 2
        else:
            i += 1
    return start


def schur_pencil(conf: dict, g: torch.Generator, device):
    """(S, T, alpha, beta): the planted generalized Schur pair and its
    eigenvalues alpha / beta (beta == 0 for an infinite one)."""
    n = int(conf["n"])
    cr, ir = float(conf["complex_ratio"]), float(conf["inf_ratio"])
    u = torch.rand(2, n, generator=g, dtype=F64, device=device)
    z = torch.randn(3, n, generator=g, dtype=F64, device=device)
    start = torch.as_tensor(block_pattern(u[0].cpu().numpy(), cr), device=device)
    second = torch.zeros_like(start)
    second[1:] = start[:-1]
    single = ~(start | second)
    r = u[1]
    inf = single & (r < ir)
    fin = single & ~inf
    # a pair [[p, b], [c, p]], b > 0 > c, T = I on the block
    p, b, c = z[0], z[1].abs() + 0.1, -(z[2].abs() + 0.1)
    sd = torch.where(start, p, 0.0)
    sd = sd + torch.where(second, torch.roll(p, 1), 0.0)
    sd = sd + torch.where(inf, z[0].abs() + 0.5, 0.0) + torch.where(fin, z[0], 0.0)
    td = torch.where(start | second, 1.0, 0.0)
    td = td + torch.where(fin, z[1].abs() + 0.5, 0.0)
    scale = 1.0 / math.sqrt(max(n, 2))
    S = torch.triu(torch.randn(n, n, generator=g, dtype=F64, device=device), 2) * scale
    T = torch.triu(torch.randn(n, n, generator=g, dtype=F64, device=device), 1) * scale
    i = torch.arange(n, device=device)
    S[i, i] = sd
    T[i, i] = td
    k = torch.nonzero(start).flatten()
    S[k, k + 1] = b[k]
    S[k + 1, k] = c[k]
    T[k, k + 1] = 0.0                     # T diagonal inside a pair block
    w = torch.sqrt(b * (-c))
    alpha = torch.complex(sd, torch.where(start, w, 0.0) - torch.where(second, torch.roll(w, 1), 0.0))
    beta = torch.where(inf, 0.0, torch.where(start | second, 1.0, td))
    return S, T, alpha, beta


def known_spectrum_pencil(conf: dict, seed: int, device) -> dict:
    n = int(conf["n"])
    g = _gen(seed, device)
    S, T, _alpha, _beta = schur_pencil(conf, g, device)
    Q0 = random_orthogonal(n, g, device)
    Z0 = random_orthogonal(n, g, device)
    return {"A": Q0 @ S @ Z0.T, "B": Q0 @ T @ Z0.T}


GENERATORS = {"random_dense": random_dense,
              "known_spectrum_pencil": known_spectrum_pencil}


def make_inputs(conf: dict, seed: int, device) -> dict:
    """The input tensors of one problem of configuration ``conf``."""
    return GENERATORS[conf["generator"]](conf, seed, device)
