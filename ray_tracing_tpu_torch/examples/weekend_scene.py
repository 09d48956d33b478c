"""Generate the classic "Ray Tracing in One Weekend" final scene as an
editor project file (the counterpart of reference data/scene1_gen.py,
which emits the GUI's UUID-keyed JSON format): a checkered ground
sphere, ~480 random small spheres (80% lambertian / 15% metal / 5%
glass), and three big spheres, grouped.

The counterpart of the JAX package's ``examples/weekend_scene.py``: the
same Document from the same seed (its keys are fresh UUIDs), built with
the port's editor.

Run: python -m ray_tracing_tpu_torch.examples.weekend_scene out.json
Render it on the card (device="cpu" without one):
  python -c "
  import json, asyncio
  from ray_tracing_tpu_torch.editor import document_from_json, generate
  import ray_tracing_tpu_torch.v4ray as v4ray
  doc = document_from_json(json.load(open('out.json')))
  scene, camera, param = generate(doc)
  r = v4ray.Renderer(param, camera, scene, device='cuda')
  img = asyncio.run(r.render())
  "
"""

from __future__ import annotations

import json
import sys

import numpy as np

from ray_tracing_tpu_torch.editor.model import Document, RendererData
from ray_tracing_tpu_torch.editor.project import document_to_json


def build(seed: int = 0) -> Document:
    rng = np.random.RandomState(seed)
    doc = Document(
        renderer=RendererData(
            width=1200, height=800, max_depth=50, background=(178, 204, 255)
        )
    )
    doc = doc.set_camera(
        (
            "perspective",
            [13.0, 2.0, 3.0, 0.0, 0.0, 0.0, 20.0,
             0.0, 1.0, 0.0, 0.1, 10.0, 0.0, 0.0],
        )
    )

    # ground: big checkered sphere (reference scene1_gen.py:68-90)
    doc, tex_a = doc.add_texture("checker dark", ("solid color", [(51, 76, 26)]))
    doc, tex_b = doc.add_texture("checker light", ("solid color", [(229, 229, 229)]))
    doc, tex_ground = doc.add_texture(
        "ground", ("checker", [tex_a, tex_b, 10.0])
    )
    doc, mat_ground = doc.add_material("ground", ("lambertian", [tex_ground]))
    doc, _ = doc.add_object(
        "ground",
        shape=("sphere", [0.0, -1000.0, 0.0, 1000.0]),
        material=mat_ground,
        visible=True,
    )

    doc, group = doc.add_group("small spheres", visible=True)
    count = 0
    for a in range(-11, 11):
        for b in range(-11, 11):
            center = np.array(
                [a + 0.9 * rng.uniform(), 0.2, b + 0.9 * rng.uniform()]
            )
            if np.linalg.norm(center - [4.0, 0.2, 0.0]) <= 0.9:
                continue
            choose = rng.uniform()
            if choose < 0.8:
                albedo = (rng.uniform(size=3) * rng.uniform(size=3) * 255).astype(int)
                doc, tex = doc.add_texture(
                    f"albedo {count}", ("solid color", [tuple(albedo)])
                )
                doc, mat = doc.add_material(
                    f"diffuse {count}", ("lambertian", [tex])
                )
            elif choose < 0.95:
                albedo = tuple((rng.uniform(0.5, 1.0, 3) * 255).astype(int))
                fuzz = float(rng.uniform(0, 0.5))
                doc, mat = doc.add_material(
                    f"metal {count}", ("metal", [albedo, fuzz])
                )
            else:
                doc, mat = doc.add_material(f"glass {count}", ("dielectric", [1.5]))
            doc, _ = doc.add_object(
                f"sphere {count}",
                parent=group,
                shape=("sphere", [float(center[0]), float(center[1]),
                                  float(center[2]), 0.2]),
                material=mat,
                visible=True,
            )
            count += 1

    doc, mat_glass = doc.add_material("big glass", ("dielectric", [1.5]))
    doc, tex_brown = doc.add_texture("brown", ("solid color", [(102, 51, 25)]))
    doc, mat_diffuse = doc.add_material("big diffuse", ("lambertian", [tex_brown]))
    doc, mat_metal = doc.add_material(
        "big metal", ("metal", [(178, 153, 127), 0.0])
    )
    for name, center, mat in [
        ("big glass", (0.0, 1.0, 0.0), mat_glass),
        ("big diffuse", (-4.0, 1.0, 0.0), mat_diffuse),
        ("big metal", (4.0, 1.0, 0.0), mat_metal),
    ]:
        doc, _ = doc.add_object(
            name,
            shape=("sphere", [*center, 1.0]),
            material=mat,
            visible=True,
        )
    return doc


if __name__ == "__main__":
    out = sys.argv[1] if len(sys.argv) > 1 else "weekend_scene.json"
    with open(out, "w") as fh:
        json.dump(document_to_json(build()), fh, indent=1)
    print(f"wrote {out}")
