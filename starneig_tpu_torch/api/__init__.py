"""Public API umbrella of the PyTorch port.

  api.sep     — standard eigenvalue problem, single process
  api.gep     — generalized eigenvalue problem, single process
  api.sep_dm  — standard eigenvalue problem, distributed (one process a rank)
  api.gep_dm  — generalized eigenvalue problem, distributed
"""

from starneig_tpu_torch.api import gep, sep
