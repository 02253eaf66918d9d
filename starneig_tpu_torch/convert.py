"""Carry inputs and configurations between the JAX package and the port.

The system has no weights: what both packages must share is the matrix
and the expert configuration.  Tests build a matrix with numpy from a
seed, hand it to both packages through these helpers, and compare the
results as numpy arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from starneig_tpu_torch import config as _config


def from_numpy(a, device="cpu"):
    """A contiguous float64 tensor on ``device`` from an array-like; a copy,
    so a read-only array (a JAX array's numpy view) is never aliased."""
    return torch.tensor(np.asarray(a, dtype=np.float64), device=device)


def to_numpy(t):
    """A numpy array from a tensor on any device."""
    return t.detach().cpu().numpy()


def conf_from_jax(conf):
    """Map a ``starneig_tpu.config`` dataclass to the port's, by field name."""
    if conf is None:
        return None
    cls = getattr(_config, type(conf).__name__)
    return cls(**{f.name: getattr(conf, f.name)
                  for f in dataclasses.fields(cls)})
