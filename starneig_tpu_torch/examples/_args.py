"""The examples' command line: ``[n] [--device DEVICE]``."""

from __future__ import annotations

import argparse


def parse(doc: str, n_default: int, argv=None):
    """(n, device) from the command line; device None means the card."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=n_default)
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    return args.n, args.device
