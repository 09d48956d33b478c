"""The ``preview`` loop: the web editor's edit and preview round
(ray_tracing_tpu_torch/editor/web.py:EditorSession), closed loop.

The set-up opens the configuration's project as the editor opens one
(``load_project``) and runs the first rounds.  A round is the handlers'
work without the socket, each under the session's lock: an edit drawn
from the seed and its reply (POST ``/api/edit`` or ``/api/undo``: the
edit, then the state's JSON), then one preview pass and its reply (GET
``/api/render?passes=1``: the document generated, compiled, rendered at
key 0, tone-mapped, its PNG in base64 in JSON).  A program without
``EditorSession.post`` and ``render_reply`` gets the calls its handlers
made in their place.

The edits, in the mix's shares, each on an object whose center the
camera sees (the editor's user edits what the preview shows): a small
sphere moved in x and z by up to ``move``; a lambertian's solid color
redrawn; a metal's albedo and fuzz redrawn; a small sphere's
visibility toggled; the camera orbited
about its look-at point by up to ``orbit_deg`` in azimuth; an undo, when
an edit made since the project was opened is there to undo (the loop's
own count: the project's opening is on the undo tree too), else one of
the others in their shares.  Objects are named by index: object *i* is
the *i*-th of the opened project's ``analyze(doc).rendered_objects``,
the order of the configuration's scene.

The comparison: the edit log, and the replies of ``compared_rounds``
rounds drawn from the seed (a reservoir over every round, the set-up's
included) and of the last round.  The reference (reference/preview.py)
applies the log to the configuration's scene and renders each compared
round's preview; ``preview_px_gap`` is the worst compared round's share
of pixels where a channel of the program's PNG differs from the
reference's image by more than 1 code.

Faults this loop can have, planted underneath the timed path:
``stale``, each preview generated from the document one edit back (the
document of the previous preview); ``altered``, each pass's image with
a quarter of its rows raised by 0.05 before the tone map.
"""

from __future__ import annotations

import base64
import json
import math
import struct
import zlib

import numpy as np

from harness.driving import Run, free, peak, window
from harness.profile import counted_launches, profile, reset_counters

EDIT_PATH = "/api/edit"
UNDO_PATH = "/api/undo"
PNG_HEAD = b'{"png": "iVBOR'  # a render reply whose PNG is there: base64 of \x89PNG


def _post(session, path: str, body: dict) -> bytes:
    """POST ``body`` to ``path`` as the program's handler does it."""
    if hasattr(session, "post"):
        return session.post(path, body)
    if path == EDIT_PATH:  # an older handler's calls
        session.apply_edit(body)
    else:
        session.tree.undo()
        session._invalidate_render()
    return json.dumps(session.state_json()).encode()


def _render(session) -> bytes:
    """GET ``/api/render?passes=1`` as the program's handler does it."""
    if hasattr(session, "render_reply"):
        return session.render_reply(1)
    png = session.render_png(preview=True, passes=1)
    return json.dumps({"png": base64.b64encode(png).decode(),
                       "iterations": session._count}).encode()


class _Draw:
    """The edits of the mix, drawn from the seed against the document as
    it stands: (path, body of the request, the reference's edit)."""

    def __init__(self, traffic: dict, doc, seed: int):
        from ray_tracing_tpu_torch.editor.model import analyze

        a = analyze(doc)
        self.keys = list(a.rendered_objects)
        self.material = [a.effective_materials[key] for key in self.keys]
        self.rng = np.random.Generator(np.random.PCG64([int(seed), 0]))
        self.tr = traffic
        self.kinds = list(traffic["mix"])
        self.p = np.asarray([traffic["mix"][k] for k in self.kinds], np.float64)
        self.small, self.lambertian, self.metal = [], [], []
        for i, key in enumerate(self.keys):
            shape = doc.objects[key].shape
            if shape[0] == "sphere" and shape[1][3] < traffic["small_radius_below"]:
                self.small.append(i)
            kind, values = doc.materials[self.material[i]].material
            if kind == "metal":
                self.metal.append(i)
            elif kind == "lambertian" and doc.textures[values[0]].texture[0] == "solid color":
                self.lambertian.append(i)
        self.depth = 0  # edits made since the project was opened, not undone

    def _kind(self) -> str:
        p = self.p if self.depth else np.where([k == "undo" for k in self.kinds], 0.0, self.p)
        return self.kinds[self.rng.choice(len(self.kinds), p=p / p.sum())]

    def _pick(self, doc, among):
        """An object of ``among`` whose center the camera sees, drawn
        uniformly (any of ``among`` where none is in view)."""
        seen = [i for i, inside in zip(among, _in_view(doc, [self.keys[i] for i in among]))
                if inside] or among
        i = int(seen[self.rng.integers(len(seen))])
        return i, self.keys[i]

    def __call__(self, doc):
        kind, g, tr = self._kind(), self.rng, self.tr
        if kind == "undo":
            self.depth -= 1
            return UNDO_PATH, {}, {"kind": "undo"}
        self.depth += 1
        if kind == "set_shape":
            i, key = self._pick(doc, self.small)
            shape_kind, values = doc.objects[key].shape
            d = g.uniform(-tr["move"], tr["move"], 2)
            center = [float(values[0] + d[0]), float(values[1]), float(values[2] + d[1])]
            body = {"kind": shape_kind, "key": str(key), "values": center + [float(values[3])]}
            edit = {"index": i, "center": center}
        elif kind == "set_texture":
            i, _ = self._pick(doc, self.lambertian)
            texture = doc.materials[self.material[i]].material[1][0]
            color = [int(c) for c in g.integers(0, 256, 3)]
            body = {"kind": "solid color", "key": str(texture), "values": [color]}
            edit = {"index": i, "color": color}
        elif kind == "set_material":
            i, _ = self._pick(doc, self.metal)
            lo, hi = tr["metal_albedo"]
            albedo = [int(c) for c in g.integers(lo, hi + 1, 3)]
            fuzz = float(g.uniform(*tr["metal_fuzz"]))
            body = {"kind": "metal", "key": str(self.material[i]), "values": [albedo, fuzz]}
            edit = {"index": i, "albedo": albedo, "fuzz": fuzz}
        elif kind == "set_object":
            i, key = self._pick(doc, self.small)
            visible = not doc.objects[key].visible
            body = {"key": str(key), "visible": visible}
            edit = {"index": i, "visible": visible}
        elif kind == "set_camera":
            camera_kind, values = doc.camera
            angle = math.radians(g.uniform(-tr["orbit_deg"], tr["orbit_deg"]))
            dx, dz = values[0] - values[3], values[2] - values[5]
            c, s = math.cos(angle), math.sin(angle)
            look_from = [float(values[3] + c * dx + s * dz), float(values[1]),
                         float(values[5] - s * dx + c * dz)]
            body = {"kind": camera_kind, "values": look_from + [float(v) for v in values[3:]]}
            edit = {"look_from": look_from}
        else:
            raise ValueError(f"unknown edit {kind!r} in the mix")
        return EDIT_PATH, {"action": kind, **body}, {"kind": kind, **edit}


def _in_view(doc, keys) -> np.ndarray:
    """Whether each sphere's center lies inside the frame of the
    document's camera (a pinhole of its vfov at the image's aspect)."""
    values = doc.camera[1]
    look_from, look_at, up = (np.asarray(values[k:k + 3], np.float64) for k in (0, 3, 7))
    w = look_from - look_at
    w /= np.linalg.norm(w)
    u = np.cross(up, w)
    u /= np.linalg.norm(u)
    v = np.cross(w, u)
    d = np.asarray([doc.objects[k].shape[1][:3] for k in keys], np.float64) - look_from
    depth = -d @ w
    half_h = math.tan(math.radians(values[6]) / 2) * np.maximum(depth, 1e-12)
    half_w = half_h * doc.renderer.width / doc.renderer.height
    return (depth > 0) & (np.abs(d @ u) < half_w) & (np.abs(d @ v) < half_h)


def _k1_bound(cell, edits, rays: int, launches: int):
    """(ms, "operations" or "bytes", the table's rows) of harness/roofline.py's
    bound of phase A over ``rays`` rays in ``launches`` launches, on the
    tables of the reference's compile of the preview of the
    configuration's scene under ``edits``."""
    from harness.roofline import phase_a_bound
    from reference.preview import Edits, preview
    from reference.render import compile_scene

    scene = Edits(cell.scene)
    for edit in edits:
        scene.apply(edit)
    tables = compile_scene(preview(scene.scene), cell.data_dir, "cpu")[0].phase_a
    bound_ms, by = phase_a_bound(tables, rays, launches)
    return bound_ms, by, f"{tables.sph.shape[0]} sphere and {tables.rect.shape[0]} rect rows"


def drive(cell, seed: int, seconds: float, traced: bool, env) -> Run:
    from ray_tracing_tpu_torch.editor.web import EditorSession

    tr = cell.traffic
    session = EditorSession(device=env.device)
    with session.lock:
        _post(session, EDIT_PATH, {"action": "load_project", "project": cell.config["project"]})
    draw = _Draw(tr, session.tree.document, seed)
    keep = int(tr["compared_rounds"])
    pick = np.random.Generator(np.random.PCG64([int(seed), 1]))
    log, kept, last, bad = [], {}, None, 0

    def one(r):
        nonlocal last, bad
        path, body, edit = draw(session.tree.document)
        log.append(edit)
        with session.lock:
            _post(session, path, body)
        with session.lock:
            reply = _render(session)
        bad += not reply.startswith(PNG_HEAD)
        last = r, reply
        if r < keep:  # the reservoir of compared rounds
            kept[r] = reply
        else:
            slot = int(pick.integers(r + 1))
            if slot < keep:
                kept.pop(sorted(kept)[slot])
                kept[r] = reply

    warm = int(tr["warmup_rounds"])
    for r in range(warm):
        one(r)
    env.sync()
    run = Run(metrics={"setup_s": env.age()}, attempted=0, failed=0, memory_peak_bytes=0,
              outputs={})
    if traced:
        _, run.trace = profile(lambda: one(warm), env.sync)
        rounds, window_s = 1, run.trace.window_s
        # untimed: the profiled round's pass again on the session's
        # renderer at the same key, for phase A's rays and launches
        reset_counters()
        _, segments = session._renderer._inner.render_with_stats(0)
        launches = counted_launches()["K1"]
        bound_ms, by, rows = _k1_bound(cell, log, segments, launches)
        run.readings.update(segments=segments, k1_launches=launches, k1_bound_ms=bound_ms)
        run.notes.append(f"K1's bound of the profiled round's phase A: {bound_ms!r} ms by {by} "
                         f"({segments} rays, {launches} launches, {rows})")
    else:
        rounds, window_s = window(seconds, lambda j: one(warm + j), "round", run.notes)
        run.metrics[tr["metric"]] = window_s * 1e3 / rounds
    env.sync()
    run.memory_peak_bytes = peak(env)
    total = warm + rounds
    run.attempted, run.failed = total, bad
    kept[last[0]] = last[1]
    doc = session.tree.document
    kinds = {k: sum(e["kind"] == k for e in log) for k in draw.kinds}
    run.outputs = dict(edits=log, replies=kept)
    run.notes.append(f"rounds: {warm} in set-up, {rounds} in the window of {window_s:.4f} s; "
                     f"{doc.renderer.width}x{doc.renderer.height} preview at depth 1, "
                     f"{len(draw.keys)} objects; edits {kinds}; compared rounds {sorted(kept)}; "
                     f"replies without a PNG: {bad}")
    del session, draw, doc
    free()
    return run


def decode_png(data: bytes) -> np.ndarray:
    """(H, W, 3) u8 of an 8-bit RGB PNG whose rows all have filter 0, as
    the editor writes them (utils/image.py:encode_png): plain zlib."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos, idat, width, height = 8, [], 0, 0
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            width, height, bits, color = struct.unpack(">IIBB", body[:10])
            if (bits, color) != (8, 2):
                raise ValueError(f"PNG of {bits} bits, color type {color}: not 8-bit RGB")
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(height, 1 + 3 * width)
    if raw[:, 0].any():
        raise ValueError("a PNG row with a filter other than 0")
    return raw[:, 1:].reshape(height, width, 3)


def _images(side: dict) -> dict:
    """{round: (H, W, 3) u8}: the program's replies decoded, or the
    reference's images."""
    if "u8" in side:
        return side["u8"]
    return {r: decode_png(base64.b64decode(json.loads(reply)["png"]))
            for r, reply in side["replies"].items()}


def reference(cell, outputs: dict, seed: int, env, state_dtype=None) -> dict:
    """The reference's preview of each compared round: the configuration's
    scene under the edits up to and including the round's."""
    from reference import preview as ref_preview

    scene = ref_preview.Edits(cell.scene)
    u8 = {}
    for r, edit in enumerate(outputs["edits"]):
        scene.apply(edit)
        if r in outputs["replies"]:
            u8[r] = ref_preview.image(scene.scene, cell.data_dir, env.device, state_dtype)
    return dict(u8=u8)


def _gaps(port: dict, ref: dict) -> dict:
    mine, theirs = _images(port), _images(ref)
    out = {}
    for r, want in theirs.items():
        got = mine[r]
        if got.shape != want.shape:
            out[r] = 1.0
            continue
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16)).max(axis=-1)
        out[r] = float((diff > 1).mean())
    return out


def numbers(port: dict, ref: dict) -> dict:
    gaps = _gaps(port, ref)
    return {"preview_px_gap": max(gaps.values()) if gaps else float("nan")}


def notes(port: dict, ref: dict) -> list:
    return [f"preview_px_gap of each compared round: {_gaps(port, ref)}"]


def _stale():
    from ray_tracing_tpu_torch.editor import web

    original = web.generate
    seen = []

    def broken(doc, *args, **kw):
        seen[:] = seen[-1:] + [doc]
        return original(seen[0], *args, **kw)

    return web, "generate", broken


def _altered():
    from ray_tracing_tpu_torch.render import renderer

    original = renderer.render_pass

    def broken(*args, **kw):
        img = original(*args, **kw).clone()
        img[: img.shape[0] // 4] += 0.05
        return img

    return renderer, "render_pass", broken


# fault -> () -> (module, attribute, its broken stand-in)
FAULTS = {"stale": _stale, "altered": _altered}
