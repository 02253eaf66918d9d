"""Public API umbrella of the PyTorch port.

  api.sep     — standard eigenvalue problem, single process
  api.gep     — generalized eigenvalue problem, single process
"""

from starneig_tpu_torch.api import gep, sep
