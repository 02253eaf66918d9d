"""Solver building blocks (PyTorch port of ``starneig_tpu.ops``)."""
