"""Hierarchical config system for yanerf_tpu_torch.

The port's own copy of ``yanerf_tpu/utils/config.py`` (the port imports
nothing of the JAX package), so both packages read the same config files.

Feature-parity goals with the reference config system
(``yanerf/utils/config.py`` of yet-another-nerf):
  * load `.py`, `.yml`/`.yaml`, `.json` config files (``Config.fromfile``)
  * ``_base_`` multi-inheritance with duplicate-key detection
  * ``_delete_=True`` to replace instead of merge a dict node
  * ``{{fileDirname}}`` / ``{{fileBasename}}`` / ``{{fileBasenameNoExtension}}``
    / ``{{fileExtname}}`` template substitution
  * ``{{_base_.dotted.key}}`` references into the merged base config
  * dotted-key CLI overrides (``merge_from_dict`` + ``DictAction``)
  * attribute-style access, pretty-printing and YAML dump

The implementation is written from scratch for this framework; only the
behavioural contract mirrors the reference.
"""

from __future__ import annotations

import argparse
import ast
import copy
import importlib
import json
import os
import os.path as osp
import re
import sys
import tempfile
import types
import uuid
import warnings
from importlib import util as importlib_util
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import yaml

BASE_KEY = "_base_"
DELETE_KEY = "_delete_"
RESERVED_KEYS = ("filename", "text", "pretty_text")


class ConfigDict(dict):
    """A dict subclass with attribute access that recursively wraps values."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        for arg in args:
            if arg is None:
                continue
            if isinstance(arg, dict):
                for k, v in arg.items():
                    self[k] = v
            elif isinstance(arg, (list, tuple)):
                for k, v in arg:
                    self[k] = v
            else:
                raise TypeError(f"Cannot build ConfigDict from {type(arg)}")
        for k, v in kwargs.items():
            self[k] = v

    @classmethod
    def _wrap(cls, value):
        if isinstance(value, ConfigDict):
            return value
        if isinstance(value, dict):
            return cls(value)
        if isinstance(value, (list, tuple)):
            return type(value)(cls._wrap(v) for v in value)
        return value

    def __setitem__(self, key, value):
        super().__setitem__(key, self._wrap(value))

    def __setattr__(self, key, value):
        self[key] = value

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError:
            raise AttributeError(f"'ConfigDict' object has no attribute '{key}'")

    def __delattr__(self, key):
        try:
            del self[key]
        except KeyError:
            raise AttributeError(f"'ConfigDict' object has no attribute '{key}'")

    def __deepcopy__(self, memo):
        out = type(self)()
        memo[id(self)] = out
        for k, v in self.items():
            dict.__setitem__(out, copy.deepcopy(k, memo), copy.deepcopy(v, memo))
        return out

    def __getstate__(self):
        return dict(self)

    def __setstate__(self, state):
        self.update(state)

    def __reduce__(self):
        return (self.__class__, (dict(self),))

    def get(self, key, default=None):
        return super().get(key, default)

    def to_dict(self) -> dict:
        return _to_plain(self)


def _to_plain(obj):
    if isinstance(obj, dict):
        return {k: _to_plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_plain(v) for v in obj)
    return obj


def _substitute_predefined_vars(text: str, filename: str) -> str:
    file_dirname = osp.dirname(filename)
    file_basename = osp.basename(filename)
    file_basename_no_ext = osp.splitext(file_basename)[0]
    file_extname = osp.splitext(filename)[1]
    mapping = {
        "fileDirname": file_dirname,
        "fileBasename": file_basename,
        "fileBasenameNoExtension": file_basename_no_ext,
        "fileExtname": file_extname,
    }
    for key, value in mapping.items():
        text = re.sub(r"\{\{\s*" + key + r"\s*\}\}", value.replace("\\", "/"), text)
    return text


_BASE_REF_PATTERN = re.compile(r"\{\{\s*" + BASE_KEY + r"\.([\w\.]+)\s*\}\}")


def _mark_base_refs(text: str) -> Tuple[str, Dict[str, str]]:
    """Replace ``{{_base_.x.y}}`` with unique placeholder strings."""
    refs: Dict[str, str] = {}

    def _repl(match):
        token = f"__base_ref_{uuid.uuid4().hex[:12]}__"
        refs[token] = match.group(1)
        return token

    return _BASE_REF_PATTERN.sub(_repl, text), refs


def _resolve_base_refs(node, base_cfg: dict, refs: Dict[str, str]):
    """Substitute placeholder tokens with values looked up in ``base_cfg``."""
    if isinstance(node, dict):
        return {k: _resolve_base_refs(v, base_cfg, refs) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_resolve_base_refs(v, base_cfg, refs) for v in node)
    if isinstance(node, str):
        if node in refs:
            return _dotted_get(base_cfg, refs[node])
        for token, dotted in refs.items():
            if token in node:
                node = node.replace(token, str(_dotted_get(base_cfg, dotted)))
        return node
    return node


def _dotted_get(cfg: dict, dotted: str):
    cur: Any = cfg
    for part in dotted.split("."):
        cur = cur[part]
    return cur


def _load_py_file(filepath: str) -> dict:
    module_name = f"_yanerf_tpu_torch_cfg_{uuid.uuid4().hex[:12]}"
    spec = importlib_util.spec_from_file_location(module_name, filepath)
    assert spec is not None and spec.loader is not None
    module = importlib_util.module_from_spec(spec)
    sys.modules[module_name] = module
    try:
        spec.loader.exec_module(module)
        cfg = {
            k: v
            for k, v in module.__dict__.items()
            if not k.startswith("__") and not isinstance(v, (types.ModuleType, types.FunctionType, type))
        }
    finally:
        del sys.modules[module_name]
    return cfg


def _file_to_dict(filename: str) -> Tuple[dict, str]:
    filename = osp.abspath(osp.expanduser(filename))
    if not osp.isfile(filename):
        raise FileNotFoundError(f"Config file not found: {filename}")
    ext = osp.splitext(filename)[1]
    if ext not in (".py", ".json", ".yml", ".yaml"):
        raise OSError(f"Only .py/.json/.yml/.yaml config files are supported, got {filename}")

    with open(filename, encoding="utf-8") as f:
        text = f.read()
    text = _substitute_predefined_vars(text, filename)
    text, base_refs = _mark_base_refs(text)

    with tempfile.TemporaryDirectory() as tmp_dir:
        tmp_path = osp.join(tmp_dir, "cfg" + ext)
        with open(tmp_path, "w", encoding="utf-8") as f:
            f.write(text)
        if ext == ".py":
            cfg_dict = _load_py_file(tmp_path)
        elif ext == ".json":
            with open(tmp_path, encoding="utf-8") as f:
                cfg_dict = json.load(f)
        else:
            with open(tmp_path, encoding="utf-8") as f:
                cfg_dict = yaml.safe_load(f)

    if cfg_dict is None:
        cfg_dict = {}
    if not isinstance(cfg_dict, dict):
        raise TypeError(f"Config file {filename} must define a mapping, got {type(cfg_dict)}")

    cfg_text = f"# {filename}\n{text}"

    if BASE_KEY in cfg_dict:
        base_files = cfg_dict.pop(BASE_KEY)
        if isinstance(base_files, str):
            base_files = [base_files]
        cfg_dir = osp.dirname(filename)
        base_cfg: dict = {}
        base_texts: List[str] = []
        for base_file in base_files:
            child_cfg, child_text = _file_to_dict(osp.join(cfg_dir, base_file))
            dup = set(base_cfg.keys()) & set(child_cfg.keys())
            if dup:
                raise KeyError(f"Duplicate keys between _base_ files: {sorted(dup)}")
            base_cfg.update(child_cfg)
            base_texts.append(child_text)
        cfg_dict = _resolve_base_refs(cfg_dict, base_cfg, base_refs)
        cfg_dict = merge_into(cfg_dict, base_cfg)
        cfg_text = "\n".join(base_texts + [cfg_text])
    elif base_refs:
        raise KeyError(f"{{{{_base_.*}}}} references used without a {BASE_KEY} key in {filename}")

    return cfg_dict, cfg_text


def _import_modules(imports, allow_failed_imports: bool = False) -> None:
    """Import the modules a config's ``custom_imports`` names."""
    if isinstance(imports, str):
        imports = [imports]
    for name in imports or []:
        try:
            importlib.import_module(name)
        except ImportError:
            if not allow_failed_imports:
                raise
            warnings.warn(f"{name} failed to import and is ignored.", UserWarning)


def merge_into(overrides: dict, base: dict) -> dict:
    """Recursively merge ``overrides`` on top of ``base`` (returns a new dict).

    A dict node in ``overrides`` carrying ``_delete_=True`` replaces the base
    node entirely instead of being merged into it.
    """
    base = copy.deepcopy(base)
    for key, value in overrides.items():
        if isinstance(value, dict):
            if value.get(DELETE_KEY, False):
                base[key] = {k: copy.deepcopy(v) for k, v in value.items() if k != DELETE_KEY}
            elif key in base and isinstance(base[key], dict):
                base[key] = merge_into(value, base[key])
            else:
                base[key] = copy.deepcopy(value)
        else:
            base[key] = value
    return base


class Config:
    """Top-level config object wrapping a :class:`ConfigDict`."""

    def __init__(self, cfg_dict: Optional[dict] = None, cfg_text: str = "", filename: str = ""):
        if cfg_dict is None:
            cfg_dict = {}
        if not isinstance(cfg_dict, dict):
            raise TypeError(f"cfg_dict must be a dict, got {type(cfg_dict)}")
        for key in cfg_dict:
            if key in RESERVED_KEYS:
                raise KeyError(f"{key} is reserved for Config internals")
        object.__setattr__(self, "_cfg_dict", ConfigDict(cfg_dict))
        object.__setattr__(self, "_text", cfg_text)
        object.__setattr__(self, "_filename", filename)

    # -- constructors ------------------------------------------------------
    @staticmethod
    def fromfile(filename: Union[str, os.PathLike], import_custom_modules: bool = True) -> "Config":
        """Load a config file.

        When the config carries a ``custom_imports`` section, the named
        modules are imported here so out-of-tree components can register
        themselves into the registries from a config file alone (the
        third-party extension seam; ref yanerf/utils/config.py:322-323)::

            custom_imports = dict(imports=["my_pkg.my_model"],
                                  allow_failed_imports=False)
        """
        filename = str(filename)
        cfg_dict, cfg_text = _file_to_dict(filename)
        if import_custom_modules and cfg_dict.get("custom_imports"):
            _import_modules(**cfg_dict["custom_imports"])
        return Config(cfg_dict, cfg_text=cfg_text, filename=filename)

    @staticmethod
    def fromstring(cfg_str: str, file_format: str) -> "Config":
        if file_format not in (".py", ".json", ".yml", ".yaml"):
            raise OSError(f"Unsupported format {file_format}")
        with tempfile.NamedTemporaryFile("w", suffix=file_format, delete=False) as f:
            f.write(cfg_str)
            tmp_name = f.name
        try:
            cfg = Config.fromfile(tmp_name)
        finally:
            os.remove(tmp_name)
        return cfg

    # -- dict-like interface -----------------------------------------------
    @property
    def filename(self) -> str:
        return self._filename

    @property
    def text(self) -> str:
        return self._text

    def __getattr__(self, name):
        return getattr(self._cfg_dict, name)

    def __setattr__(self, name, value):
        self._cfg_dict[name] = value

    def __getitem__(self, key):
        return self._cfg_dict[key]

    def __setitem__(self, key, value):
        self._cfg_dict[key] = value

    def __delitem__(self, key):
        del self._cfg_dict[key]

    def __contains__(self, key):
        return key in self._cfg_dict

    def __len__(self):
        return len(self._cfg_dict)

    def __iter__(self) -> Iterator[str]:
        return iter(self._cfg_dict)

    def __repr__(self):
        return f"Config (path: {self.filename}): {self._cfg_dict!r}"

    def keys(self):
        return self._cfg_dict.keys()

    def values(self):
        return self._cfg_dict.values()

    def items(self):
        return self._cfg_dict.items()

    def get(self, key, default=None):
        return self._cfg_dict.get(key, default)

    def copy(self) -> "Config":
        return Config(copy.deepcopy(dict(self._cfg_dict)), cfg_text=self._text, filename=self._filename)

    # -- overrides & dumping -------------------------------------------------
    def merge_from_dict(self, options: Dict[str, Any], allow_list_keys: bool = True) -> None:
        """Merge dotted-key overrides, e.g. ``{"pipeline.model.n_layers": 4}``.

        With ``allow_list_keys=True``, integer path segments index into lists,
        e.g. ``{"datasets.0.split": "train"}``.
        """
        nested: dict = {}
        for dotted, value in options.items():
            parts = dotted.split(".")
            cursor = nested
            for part in parts[:-1]:
                cursor = cursor.setdefault(part, {})
            cursor[parts[-1]] = value

        def _merge(node, target):
            for key, value in node.items():
                if isinstance(target, (list, tuple)):
                    if not (allow_list_keys and key.isdigit()):
                        raise KeyError(f"Cannot set non-integer key {key!r} on a list")
                    idx = int(key)
                    if idx >= len(target):
                        raise KeyError(f"Index {idx} exceeds list length {len(target)}")
                    if isinstance(value, dict) and isinstance(target[idx], (dict, list, tuple)):
                        if isinstance(target[idx], tuple):
                            target[idx] = list(target[idx])  # tuples are immutable
                        _merge(value, target[idx])
                    else:
                        target[idx] = value
                    continue
                existing = target.get(key)
                if isinstance(value, dict) and isinstance(existing, (dict, list, tuple)):
                    if isinstance(existing, tuple):
                        # .py configs keep tuples; element overrides need a
                        # mutable container (the merged field becomes a list)
                        target[key] = list(existing)
                        existing = target[key]
                    _merge(value, existing)
                else:
                    target[key] = value

        _merge(nested, self._cfg_dict)

    @property
    def pretty_text(self) -> str:
        return yaml.safe_dump(_to_plain(dict(self._cfg_dict)), sort_keys=False, default_flow_style=False)

    def dump(self, file: Optional[Union[str, os.PathLike]] = None):
        text = self.pretty_text
        if file is None:
            return text
        file = str(file)
        ext = osp.splitext(file)[1]
        with open(file, "w", encoding="utf-8") as f:
            if ext == ".json":
                json.dump(_to_plain(dict(self._cfg_dict)), f, indent=2)
            else:
                f.write(text)
        return None


class DictAction(argparse.Action):
    """argparse action parsing ``KEY=VALUE`` pairs into a dict.

    Values are parsed as python literals when possible (int/float/bool/None),
    with ``key="[a,b]"`` / ``key=a,b`` list syntax and nested tuples like
    ``key="[(a,b),(c,d)]"`` supported — mirroring the reference CLI contract.
    """

    @staticmethod
    def _parse_scalar(value: str):
        try:
            return int(value)
        except ValueError:
            pass
        try:
            return float(value)
        except ValueError:
            pass
        lowered = value.lower()
        if lowered in ("true", "false"):
            return lowered == "true"
        if lowered in ("none", "null"):
            return None
        return value

    @staticmethod
    def _parse_value(value: str):
        value = value.strip()
        if value.startswith(("[", "(")):
            try:
                return ast.literal_eval(value)
            except (ValueError, SyntaxError):
                # bare words aren't python literals ("[train,val]"): strip
                # the brackets and parse elementwise, else the override
                # would silently apply as the literal bracketed string
                if value.endswith("]") if value[0] == "[" else value.endswith(")"):
                    items = [
                        DictAction._parse_value(v) for v in _split_top_level(value[1:-1])
                    ]
                    return tuple(items) if value[0] == "(" else items
        if "," in value:
            return [DictAction._parse_scalar(v) for v in _split_top_level(value)]
        return DictAction._parse_scalar(value)

    def __call__(self, parser, namespace, values, option_string=None):
        options = getattr(namespace, self.dest, None) or {}
        for kv in values:
            key, sep, value = kv.partition("=")
            if not sep:
                raise ValueError(f"Invalid option '{kv}', expected KEY=VALUE")
            options[key] = self._parse_value(value)
        setattr(namespace, self.dest, options)


def _split_top_level(value: str) -> List[str]:
    """Split on commas that are not nested inside brackets/parentheses."""
    parts, depth, start = [], 0, 0
    for i, ch in enumerate(value):
        if ch in "[(":
            depth += 1
        elif ch in ")]":
            depth -= 1
        elif ch == "," and depth == 0:
            parts.append(value[start:i])
            start = i + 1
    parts.append(value[start:])
    return [p for p in (s.strip() for s in parts) if p]
