"""Local file I/O for model and checkpoint paths (the port's copy of the
local-filesystem half of ``bigdl_tpu/utils/fileio.py``; the reference's
URL-schemed stores, ``gs://`` and the like, are not ported).

``atomic_write`` and ``atomic_file_swap`` make a file appear whole or not
at all: the writer targets ``<path>.tmp``, which is renamed into place.
"""

from __future__ import annotations

import os


def _local(path):
    p = str(path)
    if "://" in p:
        raise NotImplementedError(
            f"{p!r}: URL-schemed paths are not ported; the port writes the "
            f"local filesystem only")
    return p


def file_open(path, mode="rb"):
    return open(_local(path), mode)


def file_exists(path):
    return os.path.exists(_local(path))


def file_makedirs(path):
    os.makedirs(_local(path), exist_ok=True)


def file_listdir(path):
    p = _local(path)
    return sorted(os.listdir(p)) if os.path.isdir(p) else []


def path_join(base, name):
    return os.path.join(_local(base), name)


def atomic_write(path, data):
    """Write ``data`` (bytes) so that a crash mid-write never leaves a
    truncated file at ``path``."""
    p = _local(path)
    tmp = p + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, p)


def atomic_file_swap(path, write_fn):
    """Run ``write_fn(tmp_path)``, then rename the file into ``path``."""
    p = _local(path)
    tmp = p + ".tmp"
    write_fn(tmp)
    os.replace(tmp, p)
