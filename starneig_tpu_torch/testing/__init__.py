"""Checks on solver outputs, shared by the tests and ``chip_smoke.py``."""
