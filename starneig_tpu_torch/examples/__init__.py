"""Runnable examples of the port, counterparts of the JAX package's
``examples/``: ``python -m starneig_tpu_torch.examples.<name> [n]
[--device cpu]`` (the card is the default)."""
