"""Web-based scene editor: the L8 GUI application on top of the editor
core (reference main.py's Qt MainWindow re-imagined as a single-page
app; the State machinery, undo tree, project format and preview
semantics are shared with it via ray_tracing_tpu_torch.editor).

Stdlib-only server (ThreadingHTTPServer): a JSON API over the immutable
Document + a small embedded front-end that builds forms from the plugin
property descriptors — the same descriptor-driven form engine idea as
the reference's FormState (main.py:82-243), but rendered in the browser.

Run:  python -m ray_tracing_tpu_torch.editor.web [--port 8713] [--project f.json]
      [--device cuda]
or the console script ``ray-tracing-tpu-torch-editor``.

The counterpart of ``ray_tracing_tpu/editor/web.py``: the session renders
on a ``device`` (default ``"cuda"``; ``main`` exits 1 with a message when
no GPU is present, the session raises) through the port's v4ray façade,
and ``render_png`` encodes with the port's ``utils/image.py:encode_png``
(numpy and zlib, no Pillow).  The page's HTML and JS are a verbatim
copy.  The handlers' work is the session's (``post``, ``state_reply``,
``render_reply``: the reply's bytes, without the socket), and it carries
the port's spans (``utils/profiling.py``): ``rtt.edit`` (an edit, undo
or redo), ``rtt.state`` (the state and its JSON), ``rtt.png`` (tone
map, PNG, base64 and JSON) and ``rtt.sync.web.to_host`` (the pass's
copy to the host).
"""

from __future__ import annotations

import base64
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional
from urllib.parse import parse_qs, urlparse
from uuid import UUID

import numpy as np

from ray_tracing_tpu_torch.editor.generate import generate
from ray_tracing_tpu_torch.editor.history import UndoTree
from ray_tracing_tpu_torch.editor.model import (
    CAMERA_TYPES,
    Document,
    MATERIAL_TYPES,
    RendererData,
    SHAPE_TYPES,
    TEXTURE_TYPES,
    analyze,
)
from ray_tracing_tpu_torch.editor.project import document_from_json, document_to_json
from ray_tracing_tpu_torch.utils.image import encode_png
from ray_tracing_tpu_torch.utils.profiling import span, sync
from ray_tracing_tpu_torch.v4ray_frontend.properties import (
    ColorProperty,
    FloatProperty,
    StringProperty,
    TextureProperty,
)


def _prop_meta(prop) -> Dict[str, Any]:
    if isinstance(prop, FloatProperty):
        return {"kind": "float", "name": prop.name, "default": prop.default,
                "min": prop.min, "max": prop.max}
    if isinstance(prop, ColorProperty):
        return {"kind": "color", "name": prop.name,
                "default": "#%02x%02x%02x" % tuple(prop.default)}
    if isinstance(prop, TextureProperty):
        return {"kind": "texture", "name": prop.name}
    if isinstance(prop, StringProperty):
        return {"kind": "string", "name": prop.name, "default": prop.default}
    return {"kind": "unknown", "name": getattr(prop, "name", "?")}


def _registries_meta() -> Dict[str, Any]:
    return {
        "shapes": {k: [_prop_meta(p) for p in t.properties()]
                   for k, t in SHAPE_TYPES.items()},
        "textures": {k: [_prop_meta(p) for p in t.properties()]
                     for k, t in TEXTURE_TYPES.items()},
        "materials": {k: [_prop_meta(p) for p in t.properties()]
                      for k, t in MATERIAL_TYPES.items()},
        "cameras": {k: [_prop_meta(p) for p in t.properties()]
                    for k, t in CAMERA_TYPES.items()},
    }


def _values_to_json(values):
    """Property values -> JSON-safe (UUIDs and color tuples)."""
    out = []
    for v in values:
        if isinstance(v, UUID):
            out.append({"uuid": str(v)})
        elif isinstance(v, tuple):
            out.append(list(v))
        else:
            out.append(v)
    return out


def _values_from_json(values):
    out = []
    for v in values:
        if isinstance(v, dict) and "uuid" in v:
            out.append(UUID(v["uuid"]) if v["uuid"] else None)
        elif isinstance(v, list):
            out.append(tuple(v))
        else:
            out.append(v)
    return out


class EditorSession:
    """One open document + its undo tree + render state, rendered on
    ``device``."""

    def __init__(self, document: Optional[Document] = None, *, device="cuda"):
        from ray_tracing_tpu_torch.v4ray import resolve_device

        self.device = resolve_device(device)
        doc = document or self._default_document()
        self.tree = UndoTree(doc, "new")
        self.lock = threading.Lock()
        self._renderer = None
        self._render_doc_json = None
        self._accum = None
        self._count = 0

    @staticmethod
    def _default_document() -> Document:
        doc = Document(renderer=RendererData(96, 72, 4, (40, 50, 80)))
        doc = doc.set_camera(
            ("perspective",
             [0.0, 1.0, 4.0, 0.0, 0.5, 0.0, 40.0,
              0.0, 1.0, 0.0, 0.0, 4.0, 0.0, 0.0])
        )
        doc, tex = doc.add_texture("gray", ("solid color", [(150, 150, 150)]))
        doc, mat = doc.add_material("gray mat", ("lambertian", [tex]))
        doc, _ = doc.add_object(
            "sphere", shape=("sphere", [0.0, 0.5, 0.0, 0.5]), material=mat,
            visible=True,
        )
        doc, _ = doc.add_object(
            "ground", shape=("sphere", [0.0, -100.0, 0.0, 100.0]), material=mat,
            visible=True,
        )
        return doc

    # -- state ---------------------------------------------------------
    def state_json(self) -> Dict[str, Any]:
        doc = self.tree.document
        a = analyze(doc)

        def spec(s):
            # (kind, values) -> the editor-value payload the forms
            # preload so "apply" round-trips unedited fields instead of
            # resetting them to registry defaults
            if s is None:
                return None
            return {"kind": s[0], "values": _values_to_json(list(s[1]))}

        return {
            "document": document_to_json(doc),
            "values": {
                "objects": {
                    str(k): spec(o.shape) for k, o in doc.objects.items()
                    if getattr(o, "shape", None) is not None
                },
                "textures": {
                    str(k): spec(t.texture) for k, t in doc.textures.items()
                },
                "materials": {
                    str(k): spec(m.material) for k, m in doc.materials.items()
                },
                "camera": spec(doc.camera),
            },
            "analysis": {
                "valid_textures": [str(k) for k in a.valid_textures],
                "valid_materials": [str(k) for k in a.valid_materials],
                "rendered_objects": [str(k) for k in a.rendered_objects],
                "visible_objects": [str(k) for k in a.visible_objects],
                "camera_valid": a.camera_valid,
                "display_names": {str(k): v for k, v in a.display_names.items()},
            },
            "history": [
                {"action": n.action, "current": n.key == self.tree.current}
                for n in self.tree.linear_history()
            ],
            "can_undo": self.tree.can_undo(),
            "can_redo": self.tree.can_redo(),
            "iterations": self._count,
        }

    # -- edits ---------------------------------------------------------
    def apply_edit(self, req: Dict[str, Any]) -> None:
        with span("rtt.edit"):
            self._apply_edit(req)

    def _apply_edit(self, req: Dict[str, Any]) -> None:
        doc = self.tree.document
        action = req["action"]
        if action == "add_object":
            doc, _ = doc.add_object(
                req.get("name", "object"),
                parent=UUID(req["parent"]) if req.get("parent") else None,
                visible=True,
            )
        elif action == "add_group":
            doc, _ = doc.add_group(req.get("name", "group"), visible=True)
        elif action == "add_texture":
            doc, _ = doc.add_texture(req.get("name", "texture"))
        elif action == "add_material":
            doc, _ = doc.add_material(req.get("name", "material"))
        elif action == "set_shape":
            kind = req["kind"]
            values = (_values_from_json(req["values"]) if "values" in req
                      else [p.default for p in
                            (_prop_defaults(SHAPE_TYPES[kind]))])
            doc = doc.modify_object(UUID(req["key"]), shape=(kind, values))
        elif action == "set_texture":
            kind = req["kind"]
            values = _values_from_json(req["values"])
            doc = doc.modify_texture(UUID(req["key"]), texture=(kind, values))
        elif action == "set_material":
            kind = req["kind"]
            values = _values_from_json(req["values"])
            doc = doc.modify_material(UUID(req["key"]), material=(kind, values))
        elif action == "set_object":
            changes = {}
            if "name" in req:
                changes["name"] = req["name"]
            if "visible" in req:
                changes["visible"] = bool(req["visible"])
            if "material" in req:
                changes["material"] = (
                    UUID(req["material"]) if req["material"] else None
                )
            doc = doc.modify_object(UUID(req["key"]), **changes)
        elif action == "remove_object":
            doc = doc.remove_object(UUID(req["key"]))
        elif action == "remove_texture":
            doc = doc.remove_texture(UUID(req["key"]))
        elif action == "remove_material":
            doc = doc.remove_material(UUID(req["key"]))
        elif action == "set_camera":
            doc = doc.set_camera((req["kind"], _values_from_json(req["values"])))
        elif action == "set_renderer":
            doc = doc.set_renderer(RendererData(
                width=int(req["width"]), height=int(req["height"]),
                max_depth=int(req["max_depth"]),
                background=tuple(req["background"]),
            ))
        elif action == "load_project":
            doc = document_from_json(req["project"])
        else:
            raise ValueError(f"unknown action {action!r}")
        self.tree.push(doc, action)
        self._invalidate_render()

    def _invalidate_render(self):
        self._renderer = None
        self._accum = None
        self._count = 0

    # -- replies (the handlers' work, without the socket; the caller
    # holds ``lock``) ---------------------------------------------------
    def post(self, path: str, body: Dict[str, Any]) -> Optional[bytes]:
        """The JSON reply to a POST of ``body`` to ``path``: the edit,
        undo or redo, then the state; None for any other path."""
        if path == "/api/edit":
            self.apply_edit(body)
        elif path in ("/api/undo", "/api/redo"):
            with span("rtt.edit"):
                if path == "/api/undo":
                    self.tree.undo()
                else:
                    self.tree.redo()
                self._invalidate_render()
        else:
            return None
        return self.state_reply()

    def state_reply(self) -> bytes:
        """The JSON reply of :meth:`state_json`."""
        with span("rtt.state"):
            return _reply(self.state_json())

    def render_reply(self, passes: int = 1) -> bytes:
        """The JSON reply to ``GET /api/render?passes=``: the preview PNG
        after ``passes`` more passes, in base64, and the pass count."""
        png = self.render_png(preview=True, passes=passes)
        with span("rtt.png"):
            return _reply({"png": base64.b64encode(png).decode(), "iterations": self._count})

    # -- rendering -----------------------------------------------------
    def render_png(self, preview: bool = True, passes: int = 1) -> bytes:
        import ray_tracing_tpu_torch.v4ray as v4ray

        doc = self.tree.document
        doc_json = json.dumps(document_to_json(doc), sort_keys=True) + str(preview)
        if self._renderer is None or self._render_doc_json != doc_json:
            scene, camera, param = generate(doc, preview=preview)
            self._renderer = v4ray.Renderer(param, camera, scene, device=self.device)
            self._render_doc_json = doc_json
            self._accum = np.zeros((param.height, param.width, 3), np.float32)
            self._count = 0
        for _ in range(passes):
            img = self._renderer._inner.render(self._count)
            with sync("web.to_host"):
                img = img.cpu().numpy()
            self._accum += img
            self._count += 1
        with span("rtt.png"):
            mean = self._accum / max(self._count, 1)
            u8 = (np.sqrt(np.clip(mean, 0.0, 1.0)) * 255).astype(np.uint8)
            return encode_png(u8)


def _prop_defaults(plugin):
    return plugin.properties()


def _reply(obj) -> bytes:
    return json.dumps(obj).encode()


_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>ray_tracing_tpu editor</title>
<style>
body { font-family: system-ui, sans-serif; margin: 0; display: flex; height: 100vh; background:#1e1f24; color:#ddd; }
#left { width: 300px; padding: 10px; overflow-y: auto; border-right: 1px solid #333; }
#center { flex: 1; display: flex; flex-direction: column; align-items: center; padding: 10px; }
#right { width: 320px; padding: 10px; overflow-y: auto; border-left: 1px solid #333; }
h3 { margin: 12px 0 4px; font-size: 13px; text-transform: uppercase; color:#8ab; }
ul { list-style: none; padding-left: 12px; margin: 4px 0; }
li { cursor: pointer; padding: 2px 4px; border-radius: 4px; }
li.selected { background: #2d4f67; }
li .invalid { color: #e66; }
button { background:#2d4f67; color:#ddd; border:0; border-radius:4px; padding:4px 8px; margin:2px; cursor:pointer; }
input, select { background:#2a2b31; color:#ddd; border:1px solid #444; border-radius:3px; padding:2px 4px; margin:2px; width: 110px;}
#preview { image-rendering: pixelated; border: 1px solid #444; max-width: 100%; }
label { display:inline-block; width: 130px; font-size: 12px; }
.row { margin: 2px 0; }
#history { font-size: 11px; color:#999; }
#history .cur { color:#8ab; }
</style></head>
<body>
<div id="left">
  <h3>Objects</h3><ul id="objects"></ul>
  <button onclick="edit({action:'add_object', name:'object'})">+ object</button>
  <button onclick="edit({action:'add_group', name:'group'})">+ group</button>
  <h3>Materials</h3><ul id="materials"></ul>
  <button onclick="edit({action:'add_material', name:'material'})">+ material</button>
  <h3>Textures</h3><ul id="textures"></ul>
  <button onclick="edit({action:'add_texture', name:'texture'})">+ texture</button>
  <h3>History</h3><div id="history"></div>
  <div><button id="undo" onclick="api('/api/undo',{})">undo</button>
  <button id="redo" onclick="api('/api/redo',{})">redo</button></div>
  <h3>Project</h3>
  <div><button onclick="saveProject()">save</button>
  <input type="file" id="loadfile" style="width:180px"
         onchange="loadProject(this.files[0])"/></div>
</div>
<div id="center">
  <img id="preview" width="384"/>
  <div>
    <button onclick="refreshPreview(4)">render 4 passes</button>
    <span id="iters"></span>
  </div>
</div>
<div id="right">
  <h3>Selection</h3>
  <div id="form"></div>
  <h3>Camera</h3><div id="camera"></div>
  <h3>Renderer</h3><div id="renderer"></div>
</div>
<script>
let state = null, registries = null, selected = null, selKind = null;

async function api(path, body) {
  const r = await fetch(path, {method:'POST', headers:{'Content-Type':'application/json'}, body: JSON.stringify(body)});
  const j = await r.json();
  if (j.error) { alert(j.error); return; }
  state = j; redraw(); refreshPreview(1);
}
async function edit(req) { await api('/api/edit', req); }

function li(name, key, kind, valid) {
  const el = document.createElement('li');
  el.textContent = name + (valid ? '' : ' ✗');
  if (!valid) el.classList.add('invalid');
  if (selected === key) el.classList.add('selected');
  el.dataset.key = key;
  el.onclick = () => { selected = key; selKind = kind; redraw(); };
  return el;
}

function redraw() {
  const doc = state.document, a = state.analysis;
  const objs = document.getElementById('objects'); objs.innerHTML = '';
  const addNode = (key, depth) => {
    const o = doc.objects[key];
    const el = li(' '.repeat(depth) + (o.visible ? '👁 ' : '✕ ') + o.name, key, 'object',
                  a.rendered_objects.includes(key) || o.children);
    el.style.paddingLeft = (depth*14+4) + 'px';
    objs.appendChild(el);
    (o.children || []).forEach(c => addNode(c, depth+1));
  };
  doc.root_objects.forEach(k => addNode(k, 0));
  const mats = document.getElementById('materials'); mats.innerHTML = '';
  Object.entries(doc.materials).forEach(([k, m]) =>
    mats.appendChild(li(m.name, k, 'material', a.valid_materials.includes(k))));
  const texs = document.getElementById('textures'); texs.innerHTML = '';
  Object.entries(doc.textures).forEach(([k, t]) =>
    texs.appendChild(li(t.name, k, 'texture', a.valid_textures.includes(k))));
  document.getElementById('undo').disabled = !state.can_undo;
  document.getElementById('redo').disabled = !state.can_redo;
  document.getElementById('history').innerHTML = state.history.map(h =>
    `<div class="${h.current ? 'cur' : ''}">${h.action}</div>`).join('');
  drawForm(); drawCamera(); drawRenderer();
  document.getElementById('iters').textContent = state.iterations + ' passes';
}

function formFor(kindMap, current, onApply, texOptions) {
  const div = document.createElement('div');
  const sel = document.createElement('select');
  sel.innerHTML = '<option value="">(none)</option>' + Object.keys(kindMap).map(k =>
    `<option ${current && current.type === k ? 'selected' : ''}>${k}</option>`).join('');
  div.appendChild(sel);
  const fields = document.createElement('div');
  div.appendChild(fields);
  const build = () => {
    fields.innerHTML = '';
    const kind = sel.value;
    if (!kind) return;
    kindMap[kind].forEach((p, i) => {
      const row = document.createElement('div'); row.className = 'row';
      const lab = document.createElement('label'); lab.textContent = p.name; row.appendChild(lab);
      let inp;
      if (p.kind === 'texture') {
        inp = document.createElement('select');
        inp.innerHTML = '<option value="">(none)</option>' + texOptions.map(([k, n]) =>
          `<option value="${k}">${n}</option>`).join('');
      } else if (p.kind === 'color') {
        inp = document.createElement('input'); inp.type = 'color'; inp.value = p.default;
      } else if (p.kind === 'string') {
        inp = document.createElement('input'); inp.value = p.default ?? '';
      } else {
        inp = document.createElement('input'); inp.value = p.default ?? 0;
      }
      inp.dataset.pkind = p.kind; row.appendChild(inp); fields.appendChild(row);
    });
  };
  sel.onchange = build; build();
  const apply = document.createElement('button'); apply.textContent = 'apply';
  apply.onclick = () => {
    const kind = sel.value; if (!kind) return;
    const values = [...fields.querySelectorAll('input,select')].map(inp => {
      if (inp.dataset.pkind === 'texture') return {uuid: inp.value || null};
      if (inp.dataset.pkind === 'color') {
        const v = inp.value;
        return [parseInt(v.slice(1,3),16), parseInt(v.slice(3,5),16), parseInt(v.slice(5,7),16)];
      }
      if (inp.dataset.pkind === 'string') return inp.value;
      return parseFloat(inp.value);
    });
    onApply(kind, values);
  };
  div.appendChild(apply);
  return {div, sel, fields};
}

function setFieldValues(f, kindMap, payload) {
  if (!payload) return;
  if (payload.kind && f.sel.value !== payload.kind) {
    f.sel.value = payload.kind; f.sel.onchange();
  }
  const inputs = [...f.fields.querySelectorAll('input,select')];
  payload.values.forEach((v, i) => {
    const inp = inputs[i]; if (!inp) return;
    if (inp.dataset.pkind === 'texture') inp.value = v && v.uuid ? v.uuid : '';
    else if (inp.dataset.pkind === 'color')
      inp.value = '#' + v.map(x => x.toString(16).padStart(2,'0')).join('');
    else inp.value = v;
  });
}

function drawForm() {
  const host = document.getElementById('form'); host.innerHTML = '';
  if (!selected) return;
  const doc = state.document;
  const texOptions = Object.entries(doc.textures).map(([k, t]) => [k, t.name]);
  if (selKind === 'object') {
    const o = doc.objects[selected];
    if (!o) { selected = null; return; }
    const name = document.createElement('input'); name.value = o.name;
    const vis = document.createElement('button');
    vis.textContent = o.visible ? 'visible' : 'hidden';
    vis.onclick = () => edit({action:'set_object', key:selected, visible: !o.visible});
    const matSel = document.createElement('select');
    matSel.innerHTML = '<option value="">(inherit)</option>' +
      Object.entries(doc.materials).map(([k, m]) =>
        `<option value="${k}" ${o.material===k?'selected':''}>${m.name}</option>`).join('');
    matSel.onchange = () => edit({action:'set_object', key:selected, material: matSel.value || null});
    name.onchange = () => edit({action:'set_object', key:selected, name: name.value});
    const del = document.createElement('button'); del.textContent = 'delete';
    del.onclick = () => { edit({action:'remove_object', key:selected}); selected = null; };
    host.append(name, vis, matSel, del);
    if (!o.children) {
      const f = formFor(registries.shapes, o.shape,
        (kind, values) => edit({action:'set_shape', key:selected, kind, values}), texOptions);
      host.appendChild(f.div);
      setFieldValues(f, registries.shapes, state.values.objects[selected]);
    }
  } else if (selKind === 'material') {
    const m = doc.materials[selected]; if (!m) { selected = null; return; }
    const f = formFor(registries.materials, m,
      (kind, values) => edit({action:'set_material', key:selected, kind, values}), texOptions);
    host.appendChild(f.div);
    setFieldValues(f, registries.materials, state.values.materials[selected]);
  } else if (selKind === 'texture') {
    const t = doc.textures[selected]; if (!t) { selected = null; return; }
    const f = formFor(registries.textures, t,
      (kind, values) => edit({action:'set_texture', key:selected, kind, values}), texOptions);
    host.appendChild(f.div);
    setFieldValues(f, registries.textures, state.values.textures[selected]);
  }
}

function drawCamera() {
  const host = document.getElementById('camera'); host.innerHTML = '';
  const f = formFor(registries.cameras, state.document.camera,
    (kind, values) => edit({action:'set_camera', kind, values}), []);
  host.appendChild(f.div);
  setFieldValues(f, registries.cameras, state.values.camera);
}

function drawRenderer() {
  const host = document.getElementById('renderer'); host.innerHTML = '';
  const r = state.document.render;
  ['width','height','max_depth'].forEach(k => {
    const row = document.createElement('div'); row.className='row';
    const lab = document.createElement('label'); lab.textContent = k;
    const inp = document.createElement('input'); inp.value = r[k]; inp.id = 'ren_'+k;
    row.append(lab, inp); host.appendChild(row);
  });
  const bg = document.createElement('input'); bg.type='color'; bg.id='ren_bg';
  bg.value = r.background;
  const lab = document.createElement('label'); lab.textContent = 'background';
  const row = document.createElement('div'); row.className='row'; row.append(lab, bg);
  host.appendChild(row);
  const apply = document.createElement('button'); apply.textContent = 'apply';
  apply.onclick = () => {
    const v = document.getElementById('ren_bg').value;
    edit({action:'set_renderer',
      width: +document.getElementById('ren_width').value,
      height: +document.getElementById('ren_height').value,
      max_depth: +document.getElementById('ren_max_depth').value,
      background: [parseInt(v.slice(1,3),16), parseInt(v.slice(3,5),16), parseInt(v.slice(5,7),16)]});
  };
  host.appendChild(apply);
}

async function refreshPreview(passes) {
  const r = await fetch('/api/render?passes=' + (passes||1));
  if (!r.ok) { document.getElementById('iters').textContent = 'render error'; return; }
  const j = await r.json();
  document.getElementById('preview').src = 'data:image/png;base64,' + j.png;
  document.getElementById('iters').textContent = j.iterations + ' passes';
}

async function saveProject() {
  const project = await (await fetch('/api/project')).json();
  const blob = new Blob([JSON.stringify(project, null, 1)], {type: 'application/json'});
  const a = document.createElement('a');
  a.href = URL.createObjectURL(blob); a.download = 'project.json'; a.click();
}
async function loadProject(file) {
  if (!file) return;
  const text = await file.text();
  await edit({action: 'load_project', project: JSON.parse(text)});
}

async function boot() {
  registries = await (await fetch('/api/registries')).json();
  state = await (await fetch('/api/state')).json();
  redraw();
  refreshPreview(1);
}
boot();
</script>
</body></html>
"""


class _Handler(BaseHTTPRequestHandler):
    session: EditorSession = None  # set by serve()

    def log_message(self, *args):
        pass

    def _json(self, obj, code=200):
        self._send(_reply(obj), code)

    def _send(self, data: bytes, code=200):
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        url = urlparse(self.path)
        try:
            if url.path == "/":
                data = _PAGE.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            elif url.path == "/api/state":
                with self.session.lock:
                    self._send(self.session.state_reply())
            elif url.path == "/api/registries":
                self._json(_registries_meta())
            elif url.path == "/api/render":
                passes = int(parse_qs(url.query).get("passes", ["1"])[0])
                with self.session.lock:
                    self._send(self.session.render_reply(passes))
            elif url.path == "/api/project":
                with self.session.lock:
                    self._json(document_to_json(self.session.tree.document))
            else:
                self._json({"error": "not found"}, 404)
        except Exception as e:  # surface errors to the client
            self._json({"error": f"{type(e).__name__}: {e}"}, 500)

    def do_POST(self):
        try:
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length) or b"{}")
            with self.session.lock:
                data = self.session.post(self.path, body)
                if data is None:
                    self._json({"error": "not found"}, 404)
                    return
                self._send(data)
        except Exception as e:
            self._json({"error": f"{type(e).__name__}: {e}"}, 500)


def serve(port: int = 8713, project: Optional[str] = None,
          host: str = "127.0.0.1", device="cuda") -> ThreadingHTTPServer:
    doc = None
    if project:
        with open(project) as fh:
            doc = document_from_json(json.load(fh))
    _Handler.session = EditorSession(doc, device=device)
    server = ThreadingHTTPServer((host, port), _Handler)
    return server


def main(argv=None):
    import argparse

    from ray_tracing_tpu_torch.examples import device_of

    ap = argparse.ArgumentParser(description="ray_tracing_tpu_torch web scene editor")
    ap.add_argument("--port", type=int, default=8713)
    ap.add_argument("--project", default=None, help="project JSON to open")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (default cuda; cpu to run without a GPU)")
    args = ap.parse_args(argv)
    server = serve(port=args.port, project=args.project, device=device_of(args.device))
    print(f"editor at http://127.0.0.1:{args.port}/", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
