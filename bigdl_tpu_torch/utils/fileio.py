"""Pluggable file I/O for model and checkpoint paths (the port of
``bigdl_tpu/utils/fileio.py``, reference ``utils/File.scala:26,262,301``).

Plain paths use the local filesystem (:class:`LocalFS`). A URL-schemed
path (``gs://``, ``s3://``, ``mem://`` ...) goes to the filesystem that
:func:`register_filesystem` registered for its scheme, else to fsspec
when it is installed, else it raises naming the scheme. A filesystem is
any object with ``open(path, mode)`` and ``exists(path)``; ``makedirs``
and ``listdir`` are optional (object stores have no directories).

``atomic_write`` and ``atomic_file_swap`` make a file appear whole or not
at all: locally the writer targets ``<path>.tmp``, which is renamed into
place; on a URL store the writer writes the path directly (one object
PUT, atomic there).
"""

from __future__ import annotations

import os

_FILESYSTEMS = {}


class LocalFS:
    @staticmethod
    def open(path, mode="rb"):
        return open(path, mode)

    @staticmethod
    def exists(path):
        return os.path.exists(path)

    @staticmethod
    def makedirs(path):
        os.makedirs(path, exist_ok=True)

    @staticmethod
    def listdir(path):
        return sorted(os.listdir(path)) if os.path.isdir(path) else []


def register_filesystem(scheme, fs):
    """Register ``fs`` for ``scheme://`` paths (module docstring)."""
    _FILESYSTEMS[scheme] = fs


def _scheme(path):
    p = str(path)
    if "://" in p:
        return p.split("://", 1)[0]
    return None


def filesystem_for(path):
    """The filesystem that serves ``path`` (module docstring)."""
    scheme = _scheme(path)
    if scheme is None:
        return LocalFS
    if scheme in _FILESYSTEMS:
        return _FILESYSTEMS[scheme]
    try:
        import fsspec
    except ImportError:
        raise ValueError(
            f"no filesystem registered for {scheme}:// paths and fsspec is "
            "not installed — register_filesystem() a handler") from None

    class _FsspecFS:
        @staticmethod
        def open(p, mode="rb"):
            return fsspec.open(p, mode).open()

        @staticmethod
        def exists(p):
            return fsspec.filesystem(_scheme(p)).exists(p)

        @staticmethod
        def makedirs(p):
            fsspec.filesystem(_scheme(p)).makedirs(p, exist_ok=True)

        @staticmethod
        def listdir(p):
            fs = fsspec.filesystem(_scheme(p))
            return [e.rsplit("/", 1)[-1] for e in fs.ls(p)]

    return _FsspecFS


def file_open(path, mode="rb"):
    return filesystem_for(path).open(str(path), mode)


def file_exists(path):
    return filesystem_for(path).exists(str(path))


def file_makedirs(path):
    fs = filesystem_for(path)
    if hasattr(fs, "makedirs"):
        fs.makedirs(str(path))


def file_listdir(path):
    return filesystem_for(path).listdir(str(path))


def path_join(base, name):
    """Join that keeps a URL-schemed base (``os.path.join`` would treat
    ``gs://`` as part of a relative path)."""
    b = str(base)
    if "://" in b:
        return b.rstrip("/") + "/" + name
    return os.path.join(b, name)


def path_dirname(path):
    """The directory of ``path``: a URL's part before its last ``/``, a
    local path's absolute directory."""
    p = str(path)
    if "://" in p:
        return p.rsplit("/", 1)[0]
    return os.path.dirname(os.path.abspath(p))


def atomic_write(path, data):
    """Write ``data`` (bytes) so that a crash mid-write never leaves a
    truncated file at ``path`` (module docstring)."""
    p = str(path)
    if "://" in p:
        with file_open(p, "wb") as f:
            f.write(data)
        return
    tmp = p + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, p)


def atomic_file_swap(path, write_fn):
    """Run ``write_fn(actual_path)`` so that the file appears at ``path``
    only complete (module docstring)."""
    p = str(path)
    if "://" in p:
        write_fn(p)
        return
    tmp = p + ".tmp"
    write_fn(tmp)
    os.replace(tmp, p)
