"""Per-unit sums over the program's own spans, for the per-layer readers.

The program keeps a record of each span it opens while a torch.profiler
session records (latentsplat_tpu_torch/misc/profiler.py: `records()`, each
with its id, its parent's, its host interval and, where the span keeps
one, its interval on its stream, read from CUDA events at its ends). The
traced window's units are the newest `summary["units"]` spans named after
the cell's root (`render_full` a request, `train_step` a step): the set-
up's untraced calls keep none. A reader sums the spans of a name inside
those units and divides by their number. A program that keeps no records,
or a summary without units (an untraced run), reads None.
"""

from __future__ import annotations

from fnmatch import fnmatchcase

VALUES = ("device_ms", "host_ms", "count")


def _records():
    try:
        from latentsplat_tpu_torch.misc import profiler
    except ImportError:
        return None
    records = getattr(profiler, "records", None)
    return records() if records is not None else None


def units(summary: dict, root: str):
    """The spans of each of the window's units (each root span's subtree,
    itself included), or None."""
    n = summary.get("units")
    spans = _records() if n else None
    if not spans:
        return None
    roots = [s for s in spans if s.name == root][-n:]
    if len(roots) < n:
        return None
    children: dict = {}
    for s in spans:
        children.setdefault(s.parent, []).append(s)
    out = []
    for r in roots:
        tree, todo = [], [r]
        while todo:
            s = todo.pop()
            tree.append(s)
            todo.extend(children.get(s.id, ()))
        out.append(tree)
    return out


def per_unit(summary: dict, root: str, pattern: str, value: str):
    """The mean over the window's units of the sum of `value` ("device_ms",
    "host_ms" or "count") over their spans whose name matches `pattern`
    (fnmatch: "host_read.*"); None where nothing can be read."""
    if value not in VALUES:
        raise ValueError(f"value must be one of {VALUES}, got {value!r}")
    found = units(summary, root)
    if found is None:
        return None
    total = 0.0
    for tree in found:
        for s in tree:
            if fnmatchcase(s.name, pattern):
                v = 1.0 if value == "count" else getattr(s, value)
                if v is None:       # a span that keeps no stream interval
                    return None
                total += v
    return total / len(found)
