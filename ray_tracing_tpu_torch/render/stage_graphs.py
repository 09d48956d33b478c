"""CUDA graphs of the fuzz / IR replay's compaction stages
(render/prb_scalar.py:scalar_tangent_pass through
integrator.trace_subset_dot).

Eagerly, the replay dispatches tens of thousands of small kernels a
step, each with its host dispatch and its autograd node, for a few
microseconds of device work each.  Here each compaction stage runs as a
pair of captured CUDA graphs, one for its bounces forward and one for
their backward, which a ``torch.autograd.Function`` links to the eager
ops between the stages (the alive-first sort, the write-back of the
prefix).

* Widths.  A graph has fixed shapes.  A stage bounces the first rows
  of its alive-first wavefront, at most its full width
  (:func:`stage_width`): the rows past ``live`` are dead rays, which a
  bounce leaves as they are.  Stage 0's width is the caller's, which
  pads the gathered rays with dead rays to the width the same rule
  gives.  Every bounce of a stage runs, since a graph cannot stop early.
* Inputs.  The stage's rays, the five parameter tables, the shutter
  window and the key's stream seeds (ops/rng.py:StreamKey) are copied
  into the graph's own inputs before each replay.  Every other tensor of
  the scene (geometry, K1's tables, the lights' rows, the background) is
  read where it lay at capture, so a graph serves a scene only while
  each of those tensors is still the one it was captured on, and is
  captured again otherwise.
* When.  A width without a graph is captured at its first sight and
  replayed at once; the taped forward of the same step has launched
  every kernel of the bounce eagerly before (K1's one-time attribute
  calls among them), and an eager first sight would only add a replay's
  worth of host time to the set-up.  Each stage has one memory pool,
  shared by its widths: one replay runs one width of a stage, forward
  then backward, never two at once.
* Spans: ``rtt.tangent_capture`` around each capture, and
  ``rtt.tangent_graph`` around each stage replayed forward from a graph
  (its backward replays inside the replay's backward).

A capture that fails raises.  On the CPU a stage runs eagerly at the
same widths.  The hand-written kernels' launch counters
(ops/cuda_intersect.py:LAUNCHES and the others) count the launches a
graph holds at each of its replays, and nothing at its capture, which
launches nothing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch

from ray_tracing_tpu_torch.models.scene import SceneData
from ray_tracing_tpu_torch.ops import cuda_intersect, cuda_scatter, cuda_triangles
from ray_tracing_tpu_torch.ops.intersect import mesh_strategy
from ray_tracing_tpu_torch.ops.rng import StreamKey
from ray_tracing_tpu_torch.render.integrator import stage_bounces, write_back
from ray_tracing_tpu_torch.utils.profiling import span

MAX_GRAPHS = 48  # graph pairs kept per device; the oldest goes first
FLOOR = 4096  # the least width of a stage
HEADROOM = 4  # a new width holds 1/HEADROOM more rays than the live count
# the hand-written kernels' launch counters, which a captured stage may move
COUNTERS = ((cuda_intersect, "LAUNCHES"), (cuda_intersect, "TF_LAUNCHES"),
            (cuda_intersect, "MOTION_LAUNCHES"), (cuda_scatter, "LAUNCHES"),
            (cuda_triangles, "LAUNCHES"), (cuda_triangles, "CL_LAUNCHES"))


def stage_width(live: int, last: int | None = None, n: int | None = None) -> int:
    """The width a stage bounces for ``live`` live rays, at most ``n``.

    ``last``, the width the stage took last, is kept while it holds the
    live rays and is at most twice their number.  Otherwise the width is
    the live count and 1/HEADROOM more, at least FLOOR, rounded up to a
    multiple of 2**(floor(log2 x) - 4) (16 widths an octave, so that
    nearby counts meet on one graph).  Live counts move by up to a fifth
    from step to step as the parameters move, and a capture costs as much
    host time as a few replays, so a stage keeps one width, and one graph,
    over many steps; the dead lanes cost only device time."""
    if last is not None and live <= last <= 2 * live and (n is None or last <= n):
        return last
    want = max(live + live // HEADROOM, FLOOR)
    step = 1 << (want.bit_length() - 5)
    width = -(-want // step) * step
    return width if n is None else min(width, n)


def _counts():
    return tuple(getattr(mod, name) for mod, name in COUNTERS)


def _advance(by) -> None:
    """Add ``by`` to the launch counters, one entry per COUNTERS."""
    for (mod, name), d in zip(COUNTERS, by):
        if d:
            setattr(mod, name, getattr(mod, name) + d)


def _params(scene: SceneData):
    """The tables a replay copies into a graph: color, images, metal
    albedo, fuzz, IR (the parameters), and the shutter window, which the
    renderer stamps anew each pass (None for a scene that has none)."""
    tx, mt = scene.textures, scene.materials
    return tx.color, tx.images, mt.albedo, mt.fuzz, mt.ir, scene.shutter


def _with_params(scene: SceneData, params) -> SceneData:
    color, images, albedo, fuzz, ir, shutter = params
    return dataclasses.replace(
        scene,
        textures=dataclasses.replace(scene.textures, color=color, images=images),
        materials=dataclasses.replace(scene.materials, albedo=albedo, fuzz=fuzz, ir=ir),
        shutter=shutter,
    )


def _fingerprint(scene: SceneData):
    """What a captured stage reads of ``scene`` besides the tables of
    :func:`_params`: ``(key, tensors)``, each tensor in the key by its
    address, shape, strides and dtype, each static fact as it is."""
    key, tensors = [], []

    def walk(v):
        if isinstance(v, torch.Tensor):
            key.append((v.data_ptr(), tuple(v.shape), v.stride(), v.dtype))
            tensors.append(v)
        elif dataclasses.is_dataclass(v):
            for f in dataclasses.fields(v):
                walk(getattr(v, f.name))
        elif isinstance(v, (tuple, list)):
            key.append(len(v))
            for x in v:
                walk(x)
        else:
            key.append(v)

    walk(_with_params(scene, (None,) * 6))
    return tuple(key), tensors


@contextlib.contextmanager
def _capturing(graph, pool, stream):
    """Capture the block's work on the current device into ``graph`` on
    the side ``stream``, its memory from ``pool``."""
    torch.cuda.synchronize()
    with torch.cuda.stream(stream):
        graph.capture_begin(pool=pool)
        try:
            yield
        finally:
            graph.capture_end()


class _StageGraph:
    """One stage's bounces at one width: a forward and a backward CUDA
    graph, their inputs ``(rad, thr, ro, rd, alive, ids, color, images,
    albedo, fuzz, ir, shutter, seeds)`` (a None input stays None),
    outputs ``(rad, thr, ro, rd, alive)`` and gradient buffers, and the
    launch counters' steps each graph holds (``launches``: forward,
    backward)."""

    def __init__(self, scene: SceneData, key: StreamKey, offset: int, bounces: int, args,
                 pool, stream):
        self.guard, self._scene_tensors = _fingerprint(scene)  # kept alive: read by address
        device = args[0].device  # a table left on the host would be baked in
        self.inputs = tuple(None if x is None else x.detach().to(device, copy=True)
                            .requires_grad_(x.requires_grad) for x in args)
        s = _with_params(scene, self.inputs[6:12])
        k = StreamKey(self.inputs[12], key.rows)
        self.forward, self.backward = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        before = _counts()
        with _capturing(self.forward, pool, stream), torch.enable_grad():
            outs = stage_bounces(s, k, offset, bounces, self.inputs[:6])
        forward = tuple(b - a for a, b in zip(before, _counts()))
        self.outputs = tuple(o.detach() for o in outs)
        self.differentiable = tuple(o.requires_grad for o in outs)
        diff_outs = [o for o in outs if o.requires_grad]
        wrt = [x for x in self.inputs if x is not None and x.requires_grad]
        self.grad_outputs = tuple(torch.empty_like(o) for o in diff_outs)
        grads = iter([None] * len(wrt))
        before = _counts()
        if diff_outs and wrt:
            with _capturing(self.backward, pool, stream):
                # one scalar seeds the backward (its gradient in each output
                # is 1.0 x the output's gradient buffer, bit for bit):
                # autograd.grad given grad_outputs checks their shapes through
                # torch.fx, whose first import (sympy) takes seconds.  It is
                # made here, on the capture stream, where its backward runs.
                seed = sum((o * g).sum() for o, g in zip(diff_outs, self.grad_outputs))
                grads = iter(torch.autograd.grad(seed, wrt, allow_unused=True))
        self.grad_inputs = tuple(next(grads) if x is not None and x.requires_grad else None
                                 for x in self.inputs)
        backward = tuple(b - a for a, b in zip(before, _counts()))
        self.launches = forward, backward
        _advance(-(f + b) for f, b in zip(forward, backward))  # a capture launches nothing

    def serves(self, scene: SceneData) -> bool:
        """Whether ``scene`` still holds every tensor the graph reads by
        address."""
        return _fingerprint(scene)[0] == self.guard


class _Replay(torch.autograd.Function):
    """A captured stage as one autograd node: the forward copies its
    inputs into the graph's and replays the forward graph; the backward
    copies the output gradients in and replays the backward graph."""

    @staticmethod
    def forward(ctx, graph: _StageGraph, *args):
        for static, x in zip(graph.inputs, args):
            if static is not None:
                static.copy_(x)
        graph.forward.replay()
        _advance(graph.launches[0])
        ctx.graph = graph
        outs = tuple(o.detach() for o in graph.outputs)
        ctx.mark_non_differentiable(*(o for o, d in zip(outs, graph.differentiable) if not d))
        return outs

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        graph = ctx.graph
        for static, g in zip(graph.grad_outputs,
                             (g for g, d in zip(grads, graph.differentiable) if d)):
            static.copy_(g)
        graph.backward.replay()
        _advance(graph.launches[1])
        return (None,) + tuple(None if g is None else g.detach() for g in graph.grad_inputs)


class ReplayGraphs:
    """The replay's stage graphs on one device: the ``stages`` of
    integrator.trace_stages.  ``captures`` and ``replays`` count what it
    did; a replay holds ``lock`` from its forward to its backward."""

    def __init__(self, device: torch.device):
        self.device = device
        self.lock = threading.Lock()
        self.captures = 0
        self.replays = 0
        self._graphs = {}  # (kind, width) -> _StageGraph
        self._widths = {}  # a stage's key -> the width it took last
        self._pools = {}  # stage -> its memory pool
        self._stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def __call__(self, scene: SceneData, key: StreamKey, stage: int, offset: int, bounces: int,
                 carry, live: int):
        n = carry[0].shape[0]
        tables = _params(scene) + (key.seeds,)
        # all of a graph's key but its width: which stage, which inputs
        # require grad, the tables' layout
        kind = (stage, offset, bounces, tuple(key.rows.items()),
                tuple(x.requires_grad for x in carry[:4]),
                tuple(None if x is None else (tuple(x.shape), x.dtype, x.requires_grad)
                      for x in tables))
        width = self.width(kind, live, n)
        part = tuple(x[:width] if x.dim() else x for x in carry)
        rays = part[:6]
        if self._stream is None:
            out = stage_bounces(scene, key, offset, bounces, rays)
        else:
            out = self._run(kind, width, scene, key, offset, bounces, rays + tables)
        out = tuple(out) + part[5:]  # ids and the 0-d entries pass through
        return out if width == n else write_back(carry, part, out, width)

    def width(self, key, live: int, n: int | None = None) -> int:
        """The width stage ``key`` bounces for ``live`` live rays, at most
        ``n`` (:func:`stage_width`, from the width it took last)."""
        width = self._widths[key] = stage_width(live, self._widths.get(key), n)
        return width

    def _run(self, kind, width: int, scene, key, offset, bounces, args):
        graph = self._graphs.get((kind, width))
        if graph is None or not graph.serves(scene):
            self._graphs.pop((kind, width), None)
            if len(self._graphs) >= MAX_GRAPHS:
                del self._graphs[next(iter(self._graphs))]
            pool = self._pools.setdefault(kind[0], torch.cuda.graph_pool_handle())
            with span("rtt.tangent_capture"), torch.cuda.device(self.device):
                graph = _StageGraph(scene, key, offset, bounces, args, pool, self._stream)
            self._graphs[(kind, width)] = graph
            self.captures += 1
        with span("rtt.tangent_graph"):
            out = _Replay.apply(graph, *args)
        self.replays += 1
        return out


_BY_DEVICE: dict = {}


def replay_graphs(scene: SceneData, device) -> ReplayGraphs | None:
    """The stage graphs of the replay on ``device``, or None where the
    replay runs eagerly: on the CPU, and for a scene whose triangles take
    the BVH walk (ops/bvh.py), a loop of host reads no graph can hold."""
    device = torch.device(device)
    if device.type != "cuda" or mesh_strategy(scene) == "bvh":
        return None
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _BY_DEVICE:
        _BY_DEVICE[device] = ReplayGraphs(device)
    return _BY_DEVICE[device]
