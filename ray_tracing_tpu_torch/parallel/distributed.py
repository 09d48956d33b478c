"""Process-group helpers, the PyTorch counterpart of
``ray_tracing_tpu/parallel/distributed.py``.

Every rank runs the same program with one device; the mesh
(parallel/mesh.py) splits the ray axis over the ranks, and the only
traffic is the image all_gather and the gradient all_reduce::

    from ray_tracing_tpu_torch.parallel import distributed, mesh
    distributed.initialize()            # a no-op for a single process
    m = distributed.global_mesh()
    img = mesh.sharded_render_pass(scene, camera, key, ..., mesh=m)

Nothing here reads a cluster's own configuration: the address (an
``init_method`` such as ``tcp://localhost:<port>`` or ``file://...``),
the world size and the rank are given, or come from the standard
``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK`` variables.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ray_tracing_tpu_torch.parallel.mesh import Mesh, make_mesh


def initialize(backend: str | None = None, init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None) -> None:
    """Join the process group.

    With no arguments and neither ``MASTER_ADDR`` nor ``WORLD_SIZE`` in
    the environment there is no group to join: a single process, and
    this is a no-op.  Otherwise ``torch.distributed.init_process_group``
    runs with ``backend`` (default ``nccl`` where a card is visible,
    ``gloo`` on the CPU) and its error, if any, propagates: a configured
    group that fails is never turned into a single process."""
    if dist.is_initialized():
        return
    configured = any(x is not None for x in (backend, init_method, world_size, rank))
    if not configured and not ("MASTER_ADDR" in os.environ or "WORLD_SIZE" in os.environ):
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs = {}
    if world_size is not None:
        kwargs["world_size"] = world_size
    if rank is not None:
        kwargs["rank"] = rank
    dist.init_process_group(backend, init_method=init_method, **kwargs)


def global_mesh(device="cuda") -> Mesh:
    """The mesh over every rank of the job (parallel/mesh.py:make_mesh)."""
    return make_mesh(device)


def process_info() -> dict:
    """This process's rank and the job's size (one device per rank)."""
    on = dist.is_initialized()
    return {
        "process_index": dist.get_rank() if on else 0,
        "process_count": dist.get_world_size() if on else 1,
        "backend": dist.get_backend() if on else None,
        "local_devices": torch.cuda.device_count(),
    }
