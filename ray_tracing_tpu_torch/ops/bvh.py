"""Linear BVH for the triangle-mesh path, the PyTorch counterpart of
``ray_tracing_tpu/ops/bvh.py``.

* **Build** (host, numpy): the triangles, already in the compiler's
  Morton order (models/compiler.py:morton_order, float64 centroids as
  the JAX package's native builder, which its compiler prefers over the
  float32 ``bvh.morton_order``), are split at the median of each range,
  and the nodes are laid out in DFS pre-order with skip links: on a box
  hit the next node is ``node + 1``, on a miss ``miss_link[node]``.
  Node indices grow along every path, so the walk needs no stack.
* **Walk** (plain PyTorch on the tensors' device): every ray carries a
  node pointer; each step gathers the node's packed rows, slab-tests its
  box against the ray's best t, tests a leaf's triangles in order with a
  strict ``t < best``, and advances.  The loop ends when no pointer is
  below the node count: one host read per step.

The walk is selection only: it runs on detached inputs, and the hit
record is rebuilt from the winning index (ops/intersect.py phase B).
On the JAX side it is an XLA ``while_loop``, not a Pallas kernel.

The port's compiler packs cluster tables for every mesh it Morton-sorts,
so no compiled scene reaches the walk by default: a scene bridged from
the JAX package with a BVH and no cluster tables does (models/scene.py:
scene_from_numpy), and so does one built with ``SceneBuilder.build(
bvh=True)`` (:func:`with_bvh`).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ray_tracing_tpu_torch.models.scene import _Table
from ray_tracing_tpu_torch.ops import geometry as geo

LEAF_SIZE = 4  # triangles per leaf

# walk counters (like the kernels' launch counts): calls, and steps, each
# of which reads one flag on the host
WALKS = 0
STEPS = 0


@dataclasses.dataclass(frozen=True)
class BVHTable(_Table):
    node_min: torch.Tensor  # (M, 3) f32
    node_max: torch.Tensor  # (M, 3) f32
    miss_link: torch.Tensor  # (M,) i32 next node on a box miss (M = done)
    leaf_start: torch.Tensor  # (M,) i32 first triangle of a leaf, -1 internal
    leaf_count: torch.Tensor  # (M,) i32
    # the rows one walk step gathers: geometry [min max], topology
    # [miss start count] and the leaf's LEAF_SIZE triangles [v0 e12 e13]*K
    node_f: Optional[torch.Tensor] = None  # (M, 6) f32
    node_i: Optional[torch.Tensor] = None  # (M, 3) i32
    leaf_tris: Optional[torch.Tensor] = None  # (M, LEAF_SIZE * 9) f32
    n_nodes: int = 0


def build_lbvh(tri_min: np.ndarray, tri_max: np.ndarray) -> BVHTable:
    """The LBVH over per-triangle AABBs already in Morton order (leaf ids
    are table ids), without the packed rows (:func:`pack_bvh`)."""
    node_min, node_max, lstart, lcount, ranges = [], [], [], [], []
    stack = [(0, tri_min.shape[0])]
    while stack:
        lo, hi = stack.pop()
        node_min.append(tri_min[lo:hi].min(axis=0))
        node_max.append(tri_max[lo:hi].max(axis=0))
        ranges.append((lo, hi))
        if hi - lo <= LEAF_SIZE:
            lstart.append(lo)
            lcount.append(hi - lo)
        else:
            lstart.append(-1)
            lcount.append(0)
            mid = (lo + hi) // 2
            stack.append((mid, hi))  # pre-order: the left child comes next
            stack.append((lo, mid))

    # a node's subtree is the run of nodes after it whose ranges nest in
    # its own; its miss link is the first node past that run
    m = len(node_min)
    miss = np.empty(m, np.int32)
    open_nodes: list = []  # (hi, node)
    for i, (lo, hi) in enumerate(ranges):
        while open_nodes and open_nodes[-1][0] <= lo:
            miss[open_nodes.pop()[1]] = i
        open_nodes.append((hi, i))
    for _, node in open_nodes:
        miss[node] = m

    t = torch.from_numpy
    return BVHTable(
        node_min=t(np.stack(node_min).astype(np.float32)),
        node_max=t(np.stack(node_max).astype(np.float32)),
        miss_link=t(miss),
        leaf_start=t(np.asarray(lstart, np.int32)),
        leaf_count=t(np.asarray(lcount, np.int32)),
        n_nodes=m,
    )


def pack_bvh(bvh: BVHTable, v0, e12, e13) -> BVHTable:
    """Attach the packed walk rows (host, numpy); v0/e12/e13: (T, 3) in
    the table's Morton order."""
    start = bvh.leaf_start.numpy()
    count = bvh.leaf_count.numpy()
    node_f = torch.cat([bvh.node_min, bvh.node_max], dim=1)
    node_i = torch.stack([bvh.miss_link, bvh.leaf_start, bvh.leaf_count], dim=1)
    tris = np.concatenate([np.asarray(v0), np.asarray(e12), np.asarray(e13)],
                          axis=1).astype(np.float32)
    leaf_tris = np.zeros((bvh.n_nodes, LEAF_SIZE * 9), np.float32)
    for i in np.nonzero(start >= 0)[0]:
        leaf_tris[i, :count[i] * 9] = tris[start[i]:start[i] + count[i]].reshape(-1)
    return dataclasses.replace(bvh, node_f=node_f.contiguous(), node_i=node_i.contiguous(),
                               leaf_tris=torch.from_numpy(leaf_tris))


def with_bvh(scene, tri_min: np.ndarray, tri_max: np.ndarray):
    """``scene`` with the BVH the JAX package's compiler builds
    (ray_tracing_tpu/models/compiler.py:_build_bvh) over the per-triangle
    boxes ``tri_min``/``tri_max`` (T, 3), given in the table's order, and
    without the sweep and cluster tables, so that the automatic strategy
    (ops/intersect.py:mesh_strategy) walks the BVH.  The boxes are those
    of the authored vertices (``v0 + e12`` can be an ulp off one), which
    the device tables do not keep: ``SceneBuilder.build(bvh=True)`` hands
    over its own.  The port's compiler builds no BVH otherwise: its
    cluster tables serve every mesh it sorts."""
    tr = scene.triangles.to("cpu")
    tree = build_lbvh(np.asarray(tri_min, np.float32), np.asarray(tri_max, np.float32))
    tree = pack_bvh(tree, tr.v0.numpy(), tr.e12.numpy(), tr.e13.numpy())
    bare = dataclasses.replace(scene.triangles, **{
        f.name: None for f in dataclasses.fields(tr) if f.name.startswith(("sw_", "cl_"))})
    return dataclasses.replace(scene, triangles=bare, bvh=tree.to(scene.device))


class BVHHit(NamedTuple):
    t: torch.Tensor  # (N,) f32, +inf on a miss
    index: torch.Tensor  # (N,) i32 triangle-table id of the winner
    mask: torch.Tensor  # (N,) bool


def bvh_traverse_triangles(bvh: BVHTable, ro, rd, t_min: float, t_max: float) -> BVHHit:
    """Nearest triangle hit per ray by the stackless skip-link walk.  A
    leaf's triangles are tested together; the first of the nearest takes
    the ray's best if strictly nearer, which is what testing them in
    order k = 0..3 with a strict ``t < best`` gives.  The box test clips
    to the best so far.  Adds one to ``WALKS`` and the number of steps
    (the longest path) to ``STEPS``."""
    global WALKS, STEPS
    n, m = ro.shape[0], bvh.n_nodes
    ro, rd = ro.detach(), rd.detach()
    rd_inv = 1.0 / torch.where(rd.abs() > 1e-30, rd, 1e-30)
    slot = torch.arange(LEAF_SIZE, device=ro.device)
    node = torch.zeros((n,), dtype=torch.int64, device=ro.device)
    best_t = torch.full((n,), t_max, dtype=torch.float32, device=ro.device)
    best_i = torch.full((n,), -1, dtype=torch.int64, device=ro.device)
    steps = 0
    while bool((node < m).any()):
        steps += 1
        active = node < m
        nd = node.clamp(max=m - 1)
        nf, ni = bvh.node_f[nd], bvh.node_i[nd].long()
        hit_box = geo.aabb_hit(ro, rd_inv, nf[:, 0:3], nf[:, 3:6], t_min, best_t) & active
        miss, start, count = ni[:, 0], ni[:, 1], ni[:, 2]
        lt = bvh.leaf_tris[nd].view(n, LEAF_SIZE, 9)
        t, mask, _, _, _ = geo.triangle_t(ro[:, None], rd[:, None], lt[..., 0:3], lt[..., 3:6],
                                          lt[..., 6:9], t_min, best_t[:, None])
        take = (mask & (t < best_t[:, None]) & (slot < count[:, None])
                & ((start >= 0) & hit_box)[:, None])
        t = torch.where(take, t, geo.INF)
        k = t.argmin(dim=1)  # the first of the nearest
        near = t.gather(1, k[:, None])[:, 0]
        take = near < best_t
        best_t = torch.where(take, near, best_t)
        best_i = torch.where(take, start + k, best_i)
        # an internal box hit descends; a leaf or a miss skips the subtree
        nxt = torch.where(hit_box & (start < 0), node + 1, miss)
        node = torch.where(active, nxt, node)
    WALKS += 1
    STEPS += steps
    found = best_i >= 0
    return BVHHit(t=torch.where(found, best_t, geo.INF),
                  index=torch.where(found, best_i, 0).to(torch.int32), mask=found)
