"""Faults planted in the port, to show that a cell's check catches them.

Each pipeline lists the faults its cells can have in ``FAULTS`` and plants
one with ``plant(name, port)``, a context manager that breaks the timed path
underneath a run and restores it on exit. The contract's faults, as far as
a cell can have them:

- ``stale_state``: a step returns its state unchanged;
- ``half_batch``: half of the batch left out, the mean taken over the rest;
- ``altered_answer``: one answer altered where it is produced.

No cell runs on more than one chip, so none can leave out an exchange
between chips. ``calibrate.py`` reads the faults on the chip; the CPU tests
see each one turn ``correct`` false.
"""

from __future__ import annotations

import contextlib
import importlib


@contextlib.contextmanager
def patched(obj, attr: str, value):
    """``obj.attr`` replaced by ``value`` inside the block."""
    saved = getattr(obj, attr)
    setattr(obj, attr, value)
    try:
        yield
    finally:
        setattr(obj, attr, saved)


def module(port, path: str):
    """A submodule of the package under test."""
    return importlib.import_module(f"{port.__name__}.{path}")
