"""Paths of the port: local files only. The JAX package's `utils/fs.py`
streams remote URIs through registered filesystem adapters; that is
ROADMAP.md item 7, and a remote URI raises here until then."""

from __future__ import annotations

import os


def local_path(uri) -> str:
    """The local path of `uri` (a plain path or `file://path`); any other
    scheme raises NotImplementedError."""
    s = os.fspath(uri)
    if "://" not in s:
        return s
    scheme, rest = s.split("://", 1)
    if scheme in ("", "file"):
        return rest
    raise NotImplementedError(
        f"{s!r}: remote URIs are not ported yet (utils/fs, ROADMAP.md item "
        "7); the port reads and writes local paths only")
