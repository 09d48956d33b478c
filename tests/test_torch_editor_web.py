"""The port's web scene editor (ray_tracing_tpu_torch/editor/web.py):
every case of tests/test_editor_web.py on the port, served with
device="cpu", and the port's server held against the JAX package's on
the same requests: the registries' metadata and the preview PNG of the
same edit sequence (±1 LSB)."""

import base64
import json
import sys
import threading
import urllib.request

import numpy as np
import pytest
import torch

from chip_smoke import decode_png

torch.set_num_threads(2)

# requests go to 127.0.0.1 directly, never through a configured proxy
_OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def _serve(serve, **kw):
    srv = serve(port=0, **kw)  # ephemeral port
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture
def server():
    from ray_tracing_tpu_torch.editor.web import serve

    srv, url = _serve(serve, device="cpu")
    yield url
    srv.shutdown()


@pytest.fixture
def jax_server():
    from ray_tracing_tpu.editor.web import serve

    srv, url = _serve(serve)
    yield url
    srv.shutdown()


def _get(url):
    with _OPENER.open(url, timeout=60) as r:
        return json.loads(r.read())


def _post(url, body):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    try:
        with _OPENER.open(req, timeout=60) as r:
            return json.loads(r.read())
    except urllib.error.HTTPError as e:
        return json.loads(e.read())  # API errors come back as JSON bodies


def _red_sphere(url):
    """The edit sequence of test_editor_edit_render_undo_cycle: a red
    solid texture, a lambertian material on it, set on the sphere."""
    state = _get(url + "/api/state")
    sphere_key = next(
        k for k, v in state["document"]["objects"].items() if v["name"] == "sphere"
    )
    _post(url + "/api/edit", {"action": "add_texture", "name": "t"})
    state = _get(url + "/api/state")
    tex = next(k for k, v in state["document"]["textures"].items() if v["name"] == "t")
    _post(url + "/api/edit",
          {"action": "set_texture", "key": tex, "kind": "solid color",
           "values": [[255, 0, 0]]})
    _post(url + "/api/edit", {"action": "add_material", "name": "m"})
    state = _get(url + "/api/state")
    mat = next(k for k, v in state["document"]["materials"].items() if v["name"] == "m")
    _post(url + "/api/edit",
          {"action": "set_material", "key": mat, "kind": "lambertian",
           "values": [{"uuid": tex}]})
    state = _post(url + "/api/edit",
                  {"action": "set_object", "key": sphere_key, "material": mat})
    return state, sphere_key, mat


def test_editor_edit_render_undo_cycle(server):
    state = _get(server + "/api/state")
    assert state["analysis"]["camera_valid"]
    state, sphere_key, mat = _red_sphere(server)
    assert mat in state["analysis"]["valid_materials"]

    # render: red channel dominates at the sphere
    out = _get(server + "/api/render?passes=2")
    assert out["iterations"] == 2
    img = decode_png(base64.b64decode(out["png"]), "/api/render")
    h, w = img.shape[:2]
    center = img[h // 2 - 6 : h // 2 + 6, w // 2 - 6 : w // 2 + 6]
    assert center[..., 0].mean() > center[..., 2].mean()

    # undo unwinds the material assignment
    state = _post(server + "/api/undo", {})
    sphere = state["document"]["objects"][sphere_key]
    assert sphere.get("material") != mat
    state = _post(server + "/api/redo", {})
    assert state["document"]["objects"][sphere_key]["material"] == mat


def test_editor_error_paths(server):
    out = _post(server + "/api/edit", {"action": "explode"})
    assert "unknown action" in out["error"]
    out = _post(server + "/api/edit",
                {"action": "set_shape", "key": "nope", "kind": "sphere",
                 "values": [0, 0, 0, 1]})
    assert "error" in out
    assert _get(server + "/api/state")["analysis"]["camera_valid"]  # still serving


def test_registries_meta(server):
    regs = _get(server + "/api/registries")
    assert "sphere" in regs["shapes"]
    assert [p["name"] for p in regs["shapes"]["sphere"]] == [
        "center x", "center y", "center z", "radius",
    ]
    assert "lambertian" in regs["materials"]
    assert "perspective" in regs["cameras"]
    assert regs["textures"]["image"][0]["kind"] == "string"
    assert {"mesh", "constant-medium-sphere",
            "constant-medium-cuboid"} <= regs["shapes"].keys()
    assert [p["kind"] for p in regs["shapes"]["mesh"]] == [
        "string", "string",
    ]


def test_registries_equal_jax(server, jax_server):
    """The same plugin metadata, in the same order, as the JAX server's."""
    ours, ref = _get(server + "/api/registries"), _get(jax_server + "/api/registries")
    assert ours == ref
    for kind in ref:
        assert list(ours[kind]) == list(ref[kind])


def test_mesh_object_via_api(server, tmp_path):
    obj_path = tmp_path / "tri.obj"
    obj_path.write_text("v 0 0 -3\nv 1 0 -3\nv 0 1 -3\nf 1 2 3\n")

    state = _get(server + "/api/state")
    _post(server + "/api/edit", {"action": "add_object", "name": "mesh node"})
    state = _get(server + "/api/state")
    key = next(k for k, v in state["document"]["objects"].items()
               if v["name"] == "mesh node")
    tex = next(iter(state["document"]["textures"]))
    _post(server + "/api/edit", {"action": "add_material", "name": "mm"})
    state = _get(server + "/api/state")
    mat = next(k for k, v in state["document"]["materials"].items()
               if v["name"] == "mm")
    _post(server + "/api/edit",
          {"action": "set_material", "key": mat, "kind": "lambertian",
           "values": [{"uuid": tex}]})
    _post(server + "/api/edit",
          {"action": "set_shape", "key": key,
           "kind": "mesh", "values": [str(obj_path), ""]})
    state = _post(server + "/api/edit",
                  {"action": "set_object", "key": key, "material": mat,
                   "visible": True})
    assert "error" not in state
    assert state["values"]["objects"][key] == {
        "kind": "mesh", "values": [str(obj_path), ""]
    }
    assert key in state["analysis"]["rendered_objects"]
    out = _get(server + "/api/render?passes=1")
    assert "error" not in out and out["iterations"] == 1
    state = _post(server + "/api/edit",
                  {"action": "set_shape", "key": key,
                   "kind": "mesh", "values": ["/nope.obj", ""]})
    assert key not in state["analysis"]["rendered_objects"]


def test_editor_project_roundtrip_via_api(server):
    project = _get(server + "/api/project")
    state = _post(server + "/api/edit", {"action": "load_project", "project": project})
    assert "error" not in state
    assert state["document"]["objects"].keys() == project["objects"].keys()
    minimal = {
        "render": {"width": 8, "height": 8, "max_depth": 2,
                   "background": "#102030"},
        "camera": {"type": "perspective", "look_from": [0, 0, 1],
                   "look_at": [0, 0, 0], "vfov": 60, "up": [0, 1, 0],
                   "aperture": 0, "focus_dist": 2, "time0": 0, "time1": 0},
        "root_objects": [], "objects": {}, "materials": {}, "textures": {},
    }
    state = _post(server + "/api/edit", {"action": "load_project", "project": minimal})
    assert state["document"]["render"]["width"] == 8
    assert state["can_undo"]


def test_render_png_equals_jax(server, jax_server):
    """The same project opened in both servers and the same edits (a red
    sphere, a moving sphere, a cuboid): the preview PNGs of two passes
    decode equal to JAX's within 1 LSB (u8 of sqrt of the mean; the
    preview is depth 1, pinhole, so its passes do not depend on the
    key)."""
    from PIL import Image
    import io

    project = _get(jax_server + "/api/project")
    images = []
    for url in (server, jax_server):
        _post(url + "/api/edit", {"action": "load_project", "project": project})
        state, _, mat = _red_sphere(url)
        for name, kind, values in (
                ("mover", "moving-sphere", [0.8, 0.3, 0.5, 1.0, 0.3, 0.5, 0.3, 0.0, 1.0]),
                ("box", "cuboid", [-1.2, 0.0, -0.5, -0.6, 0.6, 0.1])):
            _post(url + "/api/edit", {"action": "add_object", "name": name})
            state = _get(url + "/api/state")
            key = next(k for k, v in state["document"]["objects"].items() if v["name"] == name)
            _post(url + "/api/edit", {"action": "set_shape", "key": key, "kind": kind,
                                      "values": values})
            state = _post(url + "/api/edit", {"action": "set_object", "key": key,
                                              "material": mat})
            assert key in state["analysis"]["rendered_objects"]
        out = _get(url + "/api/render?passes=2")
        assert out["iterations"] == 2
        images.append(base64.b64decode(out["png"]))
    ours = decode_png(images[0], "/api/render")
    ref = np.asarray(Image.open(io.BytesIO(images[1])).convert("RGB"))
    assert ours.shape == ref.shape == (72, 96, 3)
    assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1
    assert (ours[..., 0].astype(int) - ours[..., 2]).max() > 50  # the red objects show


def test_render_png_without_pillow(monkeypatch):
    """render_png encodes with utils/image.py (numpy and zlib): it works
    where Pillow is absent, and its PNG decodes to the accumulated mean's
    u8 pixels."""
    from ray_tracing_tpu_torch.editor.web import EditorSession

    monkeypatch.setitem(sys.modules, "PIL", None)
    session = EditorSession(device="cpu")
    png = session.render_png(preview=True, passes=2)
    img = decode_png(png, "render_png")
    assert img.shape == (72, 96, 3) and session._count == 2
    mean = session._accum / 2
    np.testing.assert_array_equal(img, (np.sqrt(np.clip(mean, 0.0, 1.0)) * 255).astype(np.uint8))


def test_serve_and_main_need_a_gpu_unless_asked_for_the_cpu(monkeypatch, capsys):
    """serve() renders on cuda by default and raises without a GPU; main
    exits 1 with a message, never falling back to the CPU."""
    from ray_tracing_tpu_torch.editor import web

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        web.serve(port=0)
    with pytest.raises(SystemExit) as exc:
        web.main(["--port", "0"])
    assert "no CUDA device" in str(exc.value.code)
