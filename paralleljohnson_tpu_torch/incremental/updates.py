"""Edge-update batch files — the input format of the CLI's ``update``.

Two line formats, mixable in one file (blank lines and ``#`` comments
ignored):

- JSON object per line: ``{"u": 3, "v": 7, "w": 2.5}`` — ``w`` of
  ``null`` (or the string ``"inf"``) removes the edge.
- Whitespace triples: ``3 7 2.5`` — ``w`` of ``inf`` / ``x`` / ``-``
  removes the edge.

Each line is one update; the LAST update to a given ``(u, v)`` in the
file wins (``CSRGraph.apply_edge_updates`` semantics). Malformed lines
raise ``ValueError`` naming file and 1-based line number — the same
diagnosability contract as the graph loaders' ``GraphFormatError``.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

_REMOVE_TOKENS = ("inf", "x", "-", "remove", "null")


def _line_error(path, lineno: int, what: str, line: str) -> ValueError:
    return ValueError(f"{path}:{lineno}: {what} in {line!r}")


def parse_update_line(line: str):
    """One ``(u, v, w_or_None)`` triple from a line (see module
    docstring); raises bare ``ValueError`` on malformed input (the file
    loader re-raises with file:line context)."""
    line = line.strip()
    if line.startswith("{"):
        obj = json.loads(line)
        if not isinstance(obj, dict) or "u" not in obj or "v" not in obj:
            raise ValueError("JSON update needs 'u' and 'v'")
        u, v = int(obj["u"]), int(obj["v"])
        w = obj.get("w")
        if isinstance(w, str):
            if w.lower() not in _REMOVE_TOKENS:
                raise ValueError(f"bad weight {w!r}")
            w = None
        elif w is not None:
            w = float(w)
    else:
        parts = line.split()
        if len(parts) != 3:
            raise ValueError("expected 'u v w'")
        u, v = int(parts[0]), int(parts[1])
        tok = parts[2].lower()
        w = None if tok in _REMOVE_TOKENS else float(parts[2])
    if w is not None and math.isinf(w) and w > 0:
        w = None  # +inf spelled numerically: also a removal
    return u, v, w


def load_updates(path: str | Path) -> list:
    """Parse an update file into the ``(u, v, w_or_None)`` list
    ``CSRGraph.apply_edge_updates`` consumes. Range/NaN validation is
    the graph's job (it knows V); this loader only owns syntax."""
    path = Path(path)
    out = []
    with open(path, "r", encoding="utf-8") as fh:
        for lineno, line in enumerate(fh, 1):
            stripped = line.strip()
            if not stripped or stripped.startswith("#"):
                continue
            try:
                out.append(parse_update_line(stripped))
            except ValueError as e:
                raise _line_error(path, lineno, str(e) or "malformed update",
                                  stripped) from None
    if not out:
        raise ValueError(f"{path}: no updates in file")
    return out
