"""The comparison with the plain reference that decides ``correct``.

The reference (``benchmark/reference``) compiles the configuration's
scene itself, from the same file, and is handed only what the benchmark
drew from the seed (keys, the pixel sample, the fit's perturbation and
target).  It runs once the window has closed, the memory peak has been
read and the program's state is freed.  What it computes and which
numbers are compared is the loop's (``loops/<loop>.py``: ``reference``
and ``numbers``); each number's limit is the cell's.  A number that is
not finite fails its limit.  The control puts the reference itself,
its wavefront state rounded to bfloat16 after every bounce, in the
port's place.
"""

from __future__ import annotations

import numpy as np


def compare(cell, outputs: dict, seed: int, env) -> tuple:
    """(numbers, lines for standard error) of the program's outputs
    against the reference's for the same inputs."""
    loop = cell.loop
    ref = loop.reference(cell, outputs, seed, env)
    return loop.numbers(outputs, ref), loop.notes(outputs, ref)


def judge(cell, values: dict) -> bool:
    """True when every number the cell's limits name is finite and at most
    its limit."""
    return all(np.isfinite(values.get(k, np.nan)) and values[k] <= lim
               for k, lim in cell.limits.items())
