"""Filesystem path helpers, as ``yanerf_tpu/utils/path.py`` has them."""

from __future__ import annotations

import os
import os.path as osp
from pathlib import Path
from typing import Union

from .misc import is_str


def is_filepath(x) -> bool:
    return is_str(x) or isinstance(x, Path)


def fopen(filepath: Union[str, Path], *args, **kwargs):
    if is_str(filepath):
        return open(filepath, *args, **kwargs)
    if isinstance(filepath, Path):
        return filepath.open(*args, **kwargs)
    raise ValueError("`filepath` should be a string or a Path")


def check_file_exist(filename: Union[str, Path], msg_tmpl: str = 'file "{}" does not exist') -> None:
    if not osp.isfile(filename):
        raise FileNotFoundError(msg_tmpl.format(filename))


def mkdir_or_exist(dir_name: Union[str, Path], mode: int = 0o777) -> None:
    if dir_name == "":
        return
    dir_name = osp.expanduser(str(dir_name))
    os.makedirs(dir_name, mode=mode, exist_ok=True)


def symlink(src, dst, overwrite: bool = True, **kwargs) -> None:
    if os.path.lexists(dst) and overwrite:
        os.remove(dst)
    os.symlink(src, dst, **kwargs)


def scandir(dir_path: Union[str, Path], suffix=None, recursive: bool = False):
    """Yield file paths (relative to ``dir_path``) matching ``suffix``."""
    if isinstance(dir_path, (str, Path)):
        dir_path = str(dir_path)
    else:
        raise TypeError('"dir_path" must be a string or Path object')
    if suffix is not None and not isinstance(suffix, (str, tuple)):
        raise TypeError('"suffix" must be a string or tuple of strings')

    root = dir_path

    def _scandir(dir_path):
        for entry in os.scandir(dir_path):
            if not entry.name.startswith(".") and entry.is_file():
                rel_path = osp.relpath(entry.path, root)
                if suffix is None or rel_path.endswith(suffix):
                    yield rel_path
            elif recursive and entry.is_dir():
                yield from _scandir(entry.path)

    return _scandir(dir_path)


def find_vcs_root(path: str, markers=(".git",)):
    """Find the root directory containing one of ``markers``, or None."""
    if osp.isfile(path):
        path = osp.dirname(path)
    prev, cur = None, osp.abspath(osp.expanduser(path))
    while cur != prev:
        if any(osp.exists(osp.join(cur, marker)) for marker in markers):
            return cur
        prev, cur = cur, osp.split(cur)[0]
    return None
