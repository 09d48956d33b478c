"""Faults planted underneath the timed path, for the readings a limit is
set from and for the tests that see ``correct`` come out false.  Each
loop (``loops/<loop>.py``) lists the faults it can have in its
``FAULTS``: a name and a function that gives the port's module, the
attribute to patch and its broken stand-in."""

from __future__ import annotations

import contextlib

from harness.cells import load_loop


@contextlib.contextmanager
def planted(loop: str, name: str):
    """The port with fault ``name`` of loop ``loop`` planted, for the
    block's duration."""
    module, attr, broken = load_loop(loop).FAULTS[name]()
    original = getattr(module, attr)
    setattr(module, attr, broken)
    try:
        yield
    finally:
        setattr(module, attr, original)


def faults_of(loop: str) -> list:
    return list(load_loop(loop).FAULTS)
