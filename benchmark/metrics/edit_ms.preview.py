"""Host ms inside ``rtt.edit`` and ``rtt.state`` in the profiled preview
round: the edit or undo on the document and its undo tree
(editor/web.py:EditorSession.apply_edit, post), then the state and its
JSON reply (state_reply).  The two spans follow each other, so their
walls add up to their union.

Host time under the profiler: compare it with the same reading of
another run, not with pass_ms.  Nothing to read from a program without
the spans.  Moves pass_ms."""

UNIT = "ms"
SPANS = ("rtt.edit", "rtt.state")


def read(ctx):
    if ctx.loop != "preview" or ctx.trace is None:
        return None
    from harness.spans import count, wall_s

    if not all(count(ctx.trace, name) for name in SPANS):
        return None
    return sum(wall_s(ctx.trace, name) for name in SPANS) * 1e3
