"""Filesystem abstraction: local paths and remote URLs through one API
(a copy of mvsnet_tpu/io/filesystem.py).

The reference reads/writes GCS everywhere via tf.file_io — data, models and
results (reference: predictlib.py:69-76, utils.py:75-95, README.md:43-49).
Here any path with a URL scheme (gs://, s3://, memory://, ...) routes
through fsspec; plain paths use the standard library, so the hot local path
never imports or pays for fsspec.
"""

from __future__ import annotations

import os
import re
from typing import IO, List

_SCHEME_RE = re.compile(r"^[a-zA-Z][a-zA-Z0-9+.-]*://")


def is_remote(path) -> bool:
    """True for scheme-prefixed URLs (gs://, s3://, memory://, ...)."""
    return bool(_SCHEME_RE.match(str(path)))


def _fs(path):
    import fsspec

    return fsspec.core.url_to_fs(str(path))


def open_file(path, mode: str = "r") -> IO:
    """open() for local paths, fsspec for remote URLs."""
    if is_remote(path):
        import fsspec

        return fsspec.open(str(path), mode).open()
    return open(path, mode)


def exists(path) -> bool:
    if is_remote(path):
        fs, p = _fs(path)
        return fs.exists(p)
    return os.path.exists(path)


def isdir(path) -> bool:
    if is_remote(path):
        fs, p = _fs(path)
        return fs.isdir(p)
    return os.path.isdir(path)


def makedirs(path, exist_ok: bool = True) -> None:
    if is_remote(path):
        fs, p = _fs(path)
        fs.makedirs(p, exist_ok=exist_ok)
    else:
        os.makedirs(path, exist_ok=exist_ok)


def listdir(path) -> List[str]:
    """Basenames of entries under `path` (like os.listdir)."""
    if is_remote(path):
        fs, p = _fs(path)
        return sorted(e.rstrip("/").rsplit("/", 1)[-1]
                      for e in fs.ls(p, detail=False))
    return sorted(os.listdir(path))


def join(path, *parts) -> str:
    """Scheme-preserving path join."""
    if is_remote(path):
        return "/".join([str(path).rstrip("/")] + [str(p).strip("/") for p in parts])
    return os.path.join(path, *parts)


def read_bytes(path) -> bytes:
    with open_file(path, "rb") as f:
        return f.read()


def write_bytes(path, data: bytes) -> None:
    with open_file(path, "wb") as f:
        f.write(data)


def upload_tree(local_dir: str, remote_dir: str) -> None:
    """Recursively copy a local directory to a (remote) prefix."""
    makedirs(remote_dir)
    for root, _, files in os.walk(local_dir):
        rel = os.path.relpath(root, local_dir)
        for name in files:
            dst = join(remote_dir, name) if rel == "." else join(remote_dir, rel, name)
            write_bytes(dst, open(os.path.join(root, name), "rb").read())


def download_tree(remote_dir: str, local_dir: str) -> None:
    """Recursively copy a (remote) prefix into a local directory."""
    fs, p = _fs(remote_dir)
    base = p.rstrip("/")
    for entry in fs.find(base):
        rel = entry[len(base):].lstrip("/")
        dst = os.path.join(local_dir, rel)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        with fs.open(entry, "rb") as src, open(dst, "wb") as out:
            out.write(src.read())
