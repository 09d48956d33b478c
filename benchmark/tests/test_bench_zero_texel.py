"""A witness of a fault of the port, kept for the record: the taped
sweep's albedo gradient (render/prb_tape.py: ``suffix / max(A, 1e-6)``)
is 0 on a texel whose value is 0, where the derivative of the sampled
radiance is not.  Reverse autograd of the reference's dense loop and a
central difference of the loss on the same paths agree with each other
and not with the port on such texels; on every other texel the three
agree.  data/earthmap.jpg has a zero channel in 41 % of its texels."""

import numpy as np
import torch

from harness import seeds
from harness.cells import load_cell
from reference import render as ref_render
from reference import train as ref_train

SIZE, DEPTH, SEED = 48, 4, 1


def test_zero_texels_lose_their_gradient_in_the_port():
    from ray_tracing_tpu_torch import build_scene
    from ray_tracing_tpu_torch.models.camera import Camera
    from ray_tracing_tpu_torch.parallel.mesh import make_mesh, make_prb_train_step_all_direct
    from ray_tracing_tpu_torch.render.prb_scalar import params_of

    cell = load_cell("zy_scene.train")
    scene_json = dict(cell.scene)
    scene_json["renderer"] = {**scene_json["renderer"], "width": SIZE, "height": SIZE,
                              "max_depth": DEPTH}
    b = build_scene(scene_json, base_dir=cell.data_dir)
    lr = 1.0
    step = make_prb_train_step_all_direct(Camera.build(b.camera, 1.0), b.scene, width=SIZE,
                                          height=SIZE, max_depth=DEPTH, mesh=make_mesh("cpu"),
                                          lr=lr)
    p0 = params_of(b.scene)
    target = seeds.target_image(SEED, SIZE, SIZE, 4, 0.05, 0.5, "cpu")
    key = seeds.pass_key(SEED, 0)
    p1, _ = step(p0, b.scene, key, target)
    port = ((p0.images.double() - p1.images.double()) / lr).reshape(-1)

    scene, camera, *_ = ref_render.compile_scene(scene_json, cell.data_dir, "cpu")
    p = ref_train.params_of(scene)
    _, grads = ref_train.loss_and_grad(scene, camera, SIZE, SIZE, DEPTH, p, key, target, 65536)
    ref = grads["images"].double().reshape(-1)
    values = p["images"].reshape(-1)

    tol = 1e-6 + 1e-3 * ref.abs()
    off = (port - ref).abs() > tol
    assert off.any()
    # every texel the port gets wrong has the value 0, and the port gives it 0
    assert bool((values[off] == 0).all()) and bool((port[off] == 0).all())
    # a central difference of the loss on the same paths sides with the reference
    j = int(torch.nonzero(off)[torch.argmax(ref[off].abs())])
    h = 5e-2  # the loss is near quadratic in one texel: the central difference is nearly exact

    def loss_at(v):
        q = dict(p)
        flat = q["images"].reshape(-1).clone()
        flat[j] = v
        q["images"] = flat.reshape(p["images"].shape)
        return ref_train.loss_and_grad(scene, camera, SIZE, SIZE, DEPTH, q, key, target,
                                       65536)[0]

    fd = (loss_at(h) - loss_at(-h)) / (2 * h)
    np.testing.assert_allclose(fd, float(ref[j]), rtol=2e-2)
