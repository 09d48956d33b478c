"""Cells, configurations, traffic mixes and per-layer metric readers,
each a file of its own found by its name:

* ``workloads/<cell>.json``: the configuration, the traffic mix, the
  chips and the limit of every number the comparison reads;
* ``configs/<config>.json``: the scene (the reference schema, as the
  scene JSON of the upstream CLI), its ``source``, ``reduced`` and
  ``assumed``;
* ``traffic/<mix>.json``: the loop that a window drives and its
  parameters;
* ``loops/<loop>.py``: a loop a mix can name: how it drives a window,
  what the reference gives for the same inputs, the numbers compared
  and the faults it can have;
* ``metrics/<metric>.py``: the reader of one per-layer metric.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]  # the benchmark's folder
CHECKOUT = BENCH.parent


def _load(kind: str, name: str) -> dict:
    path = BENCH / kind / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"no {kind[:-1]} named {name!r}: {path} does not exist")
    with open(path) as fh:
        return json.load(fh)


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    config: dict  # the configuration's file
    traffic_name: str
    traffic: dict  # the mix's parameters
    chips: int
    limits: dict  # number compared -> its limit

    @property
    def scene(self) -> dict:
        return self.config["scene"]

    @property
    def data_dir(self) -> str:
        """The directory the scene's files (image textures, meshes) are
        read from, inside the checkout."""
        return str(CHECKOUT / self.config["data_dir"])

    @property
    def loop(self):
        """The module of the loop the cell's traffic mix names."""
        return load_loop(self.traffic["loop"])


def load_cell(name: str) -> Cell:
    w = _load("workloads", name)
    traffic = _load("traffic", w["traffic"])
    return Cell(name=name, config_name=w["config"], config=_load("configs", w["config"]),
                traffic_name=w["traffic"], traffic=traffic, chips=int(w["chips"]),
                limits=dict(w["limits"]))


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def load_loop(name: str):
    """The module ``loops/<name>.py``."""
    path = BENCH / "loops" / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"no loop named {name!r}: {path} does not exist")
    return _module(path, f"bench_loop_{name}")


def metric_readers() -> dict:
    """{metric name: its module} of every file in ``metrics/``; the name
    is the file's name without ``.py``."""
    readers = {}
    for path in sorted((BENCH / "metrics").glob("*.py")):
        readers[path.name[:-3]] = _module(path, f"bench_metric_{len(readers)}")
    return readers
