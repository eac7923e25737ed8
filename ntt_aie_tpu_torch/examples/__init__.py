"""The worked examples of the port, each the counterpart of one file of
the reference's ``examples/``, run as
``python -m ntt_aie_tpu_torch.examples.<name>`` (on the card; ``--device
cpu`` for the plain PyTorch route):

- ``rlwe_demo``: the negacyclic product in Z_p[X]/(X^n + 1);
- ``bigint_multiply [bits]``: an exact big-integer product by RNS and CRT;
- ``serving_matform_demo``: a serving loop in matrix form against a cache
  of spectra;
- ``pqc_serving_demo``: the ML-KEM and ML-DSA serving steps;
- ``distributed_demo``: the distributed four-step on ranks of
  ``parallel.launch.run_spmd``.

Each module's ``run(..., device=None)`` does the work, raises
AssertionError when a check fails and returns what it checked, with the
lines ``main`` prints under ``"lines"``. Size parameters default to the
reference's values; device None is the card, and raises without one.
"""

from __future__ import annotations

import argparse


def require(ok, what: str) -> None:
    """Raise AssertionError(what) unless ok (a check python -O keeps)."""
    if not ok:
        raise AssertionError(what)


def parse_args(argv, doc: str, *positional) -> argparse.Namespace:
    """The examples' command line: the reference's positional arguments
    (name, type, default) and --device (the card unless 'cpu')."""
    ap = argparse.ArgumentParser(description=doc.split("\n")[0])
    for name, kind, default in positional:
        ap.add_argument(name, type=kind, nargs="?", default=default)
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain PyTorch route (default: the "
                         "card)")
    return ap.parse_args(argv)


def report(out: dict) -> int:
    """Print an example's check lines; exit status 0."""
    for line in out["lines"]:
        print(line)
    return 0
