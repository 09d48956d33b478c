"""Scene-editor framework: the backend-agnostic core of the reference's
Qt application (reference main.py, 2375 LoC), redesigned as three
layers:

* :mod:`model` — an immutable :class:`Document` (scene description) with
  pure-functional mutators, and :class:`Analysis`, the derived data the
  reference computes incrementally in ``State.recalculate``
  (main.py:340-582): validity, material inheritance, rendered sets.
* :mod:`history` — the undo *tree* (not stack) with prune semantics
  (reference main.py:1598-1613, 1824-1899) and workspace persistence.
* :mod:`project` — the UUID-keyed project JSON format (reference
  main.py:584-720), bit-compatible with files written by the reference
  editor.
* :mod:`generate` — Document -> renderable scene via the plugin
  registries, with the reference's preview semantics (main.py:1515-1561).

The Qt widget layer is intentionally absent here; any frontend (Qt,
web, TUI) can sit on top of these semantics.

A copy of ``ray_tracing_tpu/editor/__init__.py`` whose only change is
its imports.
"""

from ray_tracing_tpu_torch.editor.model import (
    Analysis,
    Document,
    GroupData,
    MaterialData,
    ObjectData,
    RendererData,
    TextureData,
    analyze,
    need_rerender,
)
from ray_tracing_tpu_torch.editor.history import UndoTree
from ray_tracing_tpu_torch.editor.project import document_from_json, document_to_json
from ray_tracing_tpu_torch.editor.generate import generate

__all__ = [
    "Analysis",
    "Document",
    "GroupData",
    "MaterialData",
    "ObjectData",
    "RendererData",
    "TextureData",
    "UndoTree",
    "analyze",
    "document_from_json",
    "document_to_json",
    "generate",
    "need_rerender",
]
