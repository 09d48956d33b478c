"""Undo *tree* + workspace persistence.

The reference keeps history as an OrderedDict of nodes each pointing to
a parent and (current) child, walks parent/child on undo/redo, prunes
unreachable branches, and pickles the whole tree to a workspace file on
every edit (reference main.py:1598-1613, 1740-1899).  Same semantics
here, with JSON workspace serialization (documents serialize through
the project format) instead of pickle.

A copy of ``ray_tracing_tpu/editor/history.py`` whose only change is
its imports.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional
from uuid import UUID, uuid4

from ray_tracing_tpu_torch.editor.model import Document
from ray_tracing_tpu_torch.editor.project import document_from_json, document_to_json


@dataclass
class HistoryNode:
    key: UUID
    document: Document
    action: str  # human label of the edit that produced this state
    parent: Optional[UUID] = None
    child: Optional[UUID] = None  # the branch redo follows
    children: List[UUID] = field(default_factory=list)


class UndoTree:
    """Branching undo (reference HistoryItem graph, main.py:1598-1613)."""

    def __init__(self, initial: Document, action: str = "new"):
        root = HistoryNode(key=uuid4(), document=initial, action=action)
        self.nodes: Dict[UUID, HistoryNode] = {root.key: root}
        self.current: UUID = root.key

    @property
    def document(self) -> Document:
        return self.nodes[self.current].document

    def push(self, document: Document, action: str) -> None:
        """Record an edit; starts a new branch if redo history existed
        (reference insert_history, main.py:1833-1846)."""
        node = HistoryNode(
            key=uuid4(), document=document, action=action, parent=self.current
        )
        cur = self.nodes[self.current]
        cur.children.append(node.key)
        cur.child = node.key  # redo now follows the newest branch
        self.nodes[node.key] = node
        self.current = node.key

    def can_undo(self) -> bool:
        return self.nodes[self.current].parent is not None

    def can_redo(self) -> bool:
        return self.nodes[self.current].child is not None

    def undo(self) -> Document:
        node = self.nodes[self.current]
        if node.parent is None:
            return node.document
        self.current = node.parent
        return self.document

    def redo(self) -> Document:
        node = self.nodes[self.current]
        if node.child is None:
            return node.document
        self.current = node.child
        return self.document

    def switch_branch(self, child: UUID) -> Document:
        """Choose which branch redo follows (the reference's history
        panel allows jumping to any recorded state)."""
        assert child in self.nodes[self.current].children
        self.nodes[self.current].child = child
        return self.redo()

    def jump(self, key: UUID) -> Document:
        """Jump to any node (reference history-list click)."""
        assert key in self.nodes
        self.current = key
        # re-thread child pointers along the path root -> key so redo
        # retraces it
        node = self.nodes[key]
        while node.parent is not None:
            self.nodes[node.parent].child = node.key
            node = self.nodes[node.parent]
        return self.document

    def prune_others(self) -> None:
        """Drop everything except the root->current path
        (reference prune, main.py:1847-1899)."""
        keep = []
        k: Optional[UUID] = self.current
        while k is not None:
            keep.append(k)
            k = self.nodes[k].parent
        keep_set = set(keep)
        self.nodes = {k: v for k, v in self.nodes.items() if k in keep_set}
        for node in self.nodes.values():
            node.children = [c for c in node.children if c in keep_set]
            if node.child not in keep_set:
                node.child = None

    def linear_history(self) -> List[HistoryNode]:
        """Root -> current path (for a history list display)."""
        path = []
        k: Optional[UUID] = self.current
        while k is not None:
            path.append(self.nodes[k])
            k = self.nodes[k].parent
        return list(reversed(path))

    # -- workspace persistence (reference main.py:1740-1780) ----------
    def save(self, path: str) -> None:
        data = {
            "current": str(self.current),
            "nodes": {
                str(k): {
                    "document": document_to_json(n.document),
                    "action": n.action,
                    "parent": str(n.parent) if n.parent else None,
                    "child": str(n.child) if n.child else None,
                    "children": [str(c) for c in n.children],
                }
                for k, n in self.nodes.items()
            },
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(data, fh)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "UndoTree":
        with open(path) as fh:
            data = json.load(fh)
        tree = cls.__new__(cls)
        tree.nodes = {}
        for k, n in data["nodes"].items():
            tree.nodes[UUID(k)] = HistoryNode(
                key=UUID(k),
                document=document_from_json(n["document"]),
                action=n["action"],
                parent=UUID(n["parent"]) if n["parent"] else None,
                child=UUID(n["child"]) if n["child"] else None,
                children=[UUID(c) for c in n["children"]],
            )
        tree.current = UUID(data["current"])
        return tree
