"""Pluggable storage for datasets, guid logs, and cluster files.

The reference routes every file touch through iopath's ``PathManager`` so
the same code runs on local disk and manifold/memcache URIs
(reference: strategy.py:681-711 checkpoint writes via ``self._pathmgr``;
dataset/config.py:12-25 ``manifold://`` default data paths).  The port's
own copy of the JAX package's utils/storage.py: plain local paths take the zero-overhead
os/builtins fast path, and any URL-style path (``gs://``, ``s3://``,
``memory://``, ...) dispatches to fsspec — so bucket-hosted Panoptic or
InterHand trees, remote guid-log replay, and remote cluster files work
without code changes.

Only metadata and small-file IO belongs here.  The JPEG decode hot path
(data/pipeline.py) also calls :func:`read_bytes` — for remote roots the
decoded-view cache in the loader is the read shield; the native C++
decoder still applies (it decodes from the fetched bytes).

fsspec import stays lazy: local-only runs (tests, the bench, the
forkserver decode workers) never pay it.
"""

from __future__ import annotations

import io
import os
import re

_SCHEME_RE = re.compile(r"^[a-zA-Z][a-zA-Z0-9+.-]*://")


def is_remote(path) -> bool:
    """True when `path` is a URL-style path that dispatches to fsspec.

    ``file://`` counts: fsspec resolves it natively, whereas the os
    fast path would treat the whole URI as a literal relative name."""
    return bool(_SCHEME_RE.match(str(path)))


def _fs(path):
    import fsspec

    fs, fpath = fsspec.core.url_to_fs(str(path))
    return fs, fpath


def open_file(path, mode: str = "r"):
    """Open for read/write; text modes are UTF-8 on remote backends."""
    if not is_remote(path):
        return open(path, mode)
    fs, fpath = _fs(path)
    if "w" in mode or "a" in mode or "x" in mode:
        fs.makedirs(fs._parent(fpath), exist_ok=True)
    f = fs.open(fpath, mode if "b" in mode else mode + "b")
    if "b" in mode:
        return f
    return io.TextIOWrapper(f, encoding="utf-8")


def read_bytes(path) -> bytes:
    """Whole-file read; the image hot path (one JPEG per view) uses this."""
    if not is_remote(path):
        with open(path, "rb") as f:
            return f.read()
    fs, fpath = _fs(path)
    return fs.cat_file(fpath)


def makedirs(path) -> None:
    if not is_remote(path):
        os.makedirs(path, exist_ok=True)
        return
    fs, fpath = _fs(path)
    fs.makedirs(fpath, exist_ok=True)


def join(base, *parts) -> str:
    """os.path.join for local paths, '/'-join for remote ones."""
    if not is_remote(base):
        return os.path.join(base, *parts)
    out = str(base).rstrip("/")
    for p in parts:
        out += "/" + str(p).strip("/")
    return out
