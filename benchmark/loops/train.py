"""The ``train`` loop: the direct full-parameter SGD step
(parallel/mesh.py:make_prb_train_step_all_direct) on one card, closed
loop, steps back to back.  Step i takes 1 spp of every pixel at
``fold_in(key(seed), i)``, from the scene's five parameter sets each
scaled by ``1 +- perturb`` (uniform from the seed) towards a target
image drawn from the seed.  The set-up runs the first ``setup_steps``
steps, which the reference follows.

The reference (reverse autograd of its dense loop) computes the start
from its own compile of the scene and the seed, the first step's loss
and gradient there, and each later step's at the port's own state
before that step, under the step's key: from its own state it parts
from the port's by the second step on some seeds (PERF.md).  Compared:

* ``start_gap``: the largest difference between the port's starting
  parameters and the reference's (exact: 0);
* ``loss_gap``: the worst step's relative loss gap;
* ``grad_gap``: per step and leaf, the gap between the norm of the
  port's gradient as the optimizer got it (``(p_i - p_i+1) / lr``, from
  its states) and the reference's, over the larger of the reference
  leaf's norm and the median leaf's; the worst;
* ``leaf_grad_gap``: the same gap over the reference leaf's own norm,
  the worst of the leaves whose reference gradient is above rounding
  (its float32 update ``p - lr g`` changes the leaf; a gradient below
  that leaves the state as it was on both sides): so a small leaf, as
  the image atlas's, is held to its own size.

Faults this loop can have, planted underneath the timed path:
``unchanged``, each step returning the state it was given;
``half_batch``, each step tracing only the first half of its rays and
taking the mean over them (the loss, and so every gradient, doubled).
"""

from __future__ import annotations

import numpy as np

from harness import seeds
from harness.driving import Run, free, peak, window
from harness.profile import profile


def drive(cell, seed: int, seconds: float, traced: bool, env) -> Run:
    from ray_tracing_tpu_torch import build_scene
    from ray_tracing_tpu_torch.models.camera import Camera
    from ray_tracing_tpu_torch.parallel.mesh import make_mesh, make_prb_train_step_all_direct
    from ray_tracing_tpu_torch.render.prb_scalar import AllParams, params_of

    tr = cell.traffic
    bundle = build_scene(cell.scene, base_dir=cell.data_dir)
    rp = bundle.renderer
    width, height, depth = rp.width, rp.height, rp.max_depth or 20
    lr = float(tr["lr"])
    scene = bundle.scene.to(env.device)
    camera = Camera.build(bundle.camera, width / height).to(env.device)
    mesh = make_mesh(env.device)
    step = make_prb_train_step_all_direct(camera, scene, width=width, height=height,
                                          max_depth=depth, mesh=mesh, lr=lr)
    p0 = AllParams(**seeds.perturb(params_of(scene)._asdict(), seed, float(tr["perturb"])))
    target = seeds.target_image(seed, width, height, int(tr["target_grid"]),
                                *tr["target_range"], env.device)
    state, states, losses = p0, [p0], []
    for i in range(int(tr["setup_steps"])):
        state, loss = step(state, scene, seeds.pass_key(seed, i), target)
        states.append(state)
        losses.append(loss)
    env.sync()
    run = Run(metrics={"setup_s": env.age()}, attempted=0, failed=0, memory_peak_bytes=0,
              outputs={})
    i0 = len(states) - 1

    def one(j):
        nonlocal state
        state, loss = step(state, scene, seeds.pass_key(seed, i0 + j), target)
        losses.append(loss)

    if traced:
        _, run.trace = profile(lambda: one(0), env.sync)
        steps, window_s = 1, run.trace.window_s
    else:
        steps, window_s = window(seconds, one, "step", run.notes)
        run.metrics[tr["metric"]] = window_s * 1e3 / steps
    env.sync()
    run.memory_peak_bytes = peak(env)
    loss_values = [float(x) for x in losses]
    run.attempted = len(loss_values)
    run.failed = sum(not np.isfinite(x) for x in loss_values)
    n_setup = int(tr["setup_steps"])
    host = [{k: v.detach().cpu() for k, v in zip(AllParams._fields, p)}
            for p in states[:n_setup + 1]]
    run.outputs = dict(
        losses=loss_values[:n_setup],
        grad_norms=[{k: float(((a[k].double() - b[k].double()) / lr).norm()) for k in a}
                    for a, b in zip(host, host[1:])],
        start=host[0], states=host[:n_setup],
        keys=[seeds.pass_key(seed, i) for i in range(n_setup)],
    )
    run.notes.append(f"steps: {n_setup} in set-up, {steps} in the window of {window_s:.4f} s; "
                     f"{width}x{height} depth {depth}, lr {lr}; losses {loss_values}")
    del step, scene, camera, state, states, p0, target
    free()
    return run


def reference(cell, outputs: dict, seed: int, env, state_dtype=None) -> dict:
    """The reference's start, its first step's loss and leaf norms there,
    and each later step's at the port's state before it."""
    from reference import train as ref_train

    scene = cell.scene
    tr = cell.traffic
    width, height = scene["renderer"]["width"], scene["renderer"]["height"]
    target = seeds.target_image(seed, width, height, int(tr["target_grid"]),
                                *tr["target_range"], env.device)
    start, losses, grads, moves = ref_train.follow(
        scene, cell.data_dir, env.device,
        perturb=lambda p: seeds.perturb(p, seed, float(tr["perturb"])),
        states=outputs["states"], target=target, keys=outputs["keys"],
        tile=int(tr["reference_tile"]), lr=float(tr["lr"]), state_dtype=state_dtype)
    first = grads[0]["images"]
    return dict(losses=losses, start={k: v.cpu() for k, v in start.items()}, moves=moves,
                grad_norms=[{k: float(g.double().norm()) for k, g in step.items()}
                            for step in grads],
                # the image leaf's first gradient on texels whose starting
                # value is 0 (render/prb_tape.py gives them none)
                zero_texel_norm=float(first[start["images"] == 0].double().norm()))


def _rel(a: float, b: float, floor: float) -> float:
    return abs(a - b) / max(abs(b), floor, 1e-30)


def _largest_difference(a, b) -> float:
    if a.shape != b.shape:
        return float("inf")
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def numbers(port: dict, ref: dict) -> dict:
    losses = [_rel(a, b, 0.0) for a, b in zip(port["losses"], ref["losses"])]
    if len(port["losses"]) != len(ref["losses"]):
        losses.append(float("inf"))
    grad, leaf = [], []
    for p, r, moves in zip(port["grad_norms"], ref["grad_norms"], ref["moves"]):
        med = float(np.median(list(r.values())))
        grad += [_rel(p[k], r[k], med) for k in r]
        leaf += [_rel(p[k], r[k], 0.0) for k in r if moves[k]]
    return {
        "start_gap": max(_largest_difference(port["start"][k], ref["start"][k])
                         for k in ref["start"]),
        "loss_gap": max(losses),
        "grad_gap": max(grad),
        "leaf_grad_gap": max(leaf, default=0.0),
    }


def notes(port: dict, ref: dict) -> list:
    """Per-step, per-leaf gradient norms, port beside reference, for
    standard error."""
    lines = [f"step {i + 1}: loss {port['losses'][i]!r} (reference {ref['losses'][i]!r}); "
             + "; ".join(f"{k} {p[k]!r} ({r[k]!r})" for k in r)
             for i, (p, r) in enumerate(zip(port["grad_norms"], ref["grad_norms"]))]
    if "zero_texel_norm" in ref:
        lines.append(f"leaf images: reference first gradient norm on texels of value 0: "
                     f"{ref['zero_texel_norm']!r}")
    return lines


def _unchanged():
    from ray_tracing_tpu_torch.parallel import mesh

    make = mesh.make_prb_train_step_all_direct

    def broken_make(*args, **kw):
        step = make(*args, **kw)

        def broken(params, scene, key, target):
            return params, step(params, scene, key, target)[1]

        return broken

    return mesh, "make_prb_train_step_all_direct", broken_make


def _half_batch():
    from ray_tracing_tpu_torch.parallel import mesh

    tiled = mesh.tiled_loss_and_grad

    def broken(tile_loss, params, scene, ro, rd, key, max_depth, **kw):
        half = ro.shape[0] // 2
        return tiled(lambda rad, rows: 2.0 * tile_loss(rad, rows), params, scene, ro[:half],
                     rd[:half], key, max_depth, **kw)

    return mesh, "tiled_loss_and_grad", broken


# fault -> () -> (module, attribute, its broken stand-in)
FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch}
