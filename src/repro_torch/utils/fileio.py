"""Crash-safe file writes (a copy of ``repro/utils/fileio.py``).

Any state a process persists for its *next* life -- the kernel tuning
cache, a server's ``--metrics-dump`` snapshot -- must survive the process
dying mid-write.  The classic recipe: write a temp file **in the target
directory** (``os.replace`` is only atomic within one filesystem), fsync,
then atomically rename over the destination.  A reader (or a concurrent
writer) can never observe a truncated or interleaved file, and an
interrupted write leaves the previous snapshot intact.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Callable, TextIO

__all__ = ["atomic_write_json", "atomic_write_text"]


def _atomic_write(path: str, write: Callable[[TextIO], None], prefix: str) -> str:
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(prefix=prefix, suffix=".tmp", dir=d)
    try:
        with os.fdopen(fd, "w") as f:
            write(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def atomic_write_text(path: str, text: str, *, prefix: str = ".tmp-") -> str:
    """Atomically replace ``path`` with ``text`` (tempfile + fsync +
    ``os.replace``).  Returns ``path``.  On any failure the temp file is
    removed and the previous ``path`` contents are untouched."""
    return _atomic_write(path, lambda f: f.write(text), prefix)


def atomic_write_json(
    path: str, payload: Any, *, indent: int = 2, sort_keys: bool = True,
    prefix: str = ".tmp-",
) -> str:
    """:func:`atomic_write_text` for a JSON payload.  Serialization streams
    into the temp file, so a dump that dies half-way (disk full, unserializable
    leaf) leaves the destination untouched."""

    def write(f: TextIO) -> None:
        json.dump(payload, f, indent=indent, sort_keys=sort_keys)
        f.write("\n")

    return _atomic_write(path, write, prefix)
