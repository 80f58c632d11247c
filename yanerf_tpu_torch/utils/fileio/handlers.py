"""Format handlers for unified load/dump: json, yaml and pickle.

``_json_default`` writes numpy scalars and arrays (and sets) as the JAX
package's does; tensors are not JSON types here either.
"""

from __future__ import annotations

import json
import pickle
from abc import ABCMeta, abstractmethod

import numpy as np
import yaml


class BaseFileHandler(metaclass=ABCMeta):
    # Whether the format is binary (opened with 'b' mode).
    str_like = True

    @abstractmethod
    def load_from_fileobj(self, file, **kwargs):
        ...

    @abstractmethod
    def dump_to_fileobj(self, obj, file, **kwargs):
        ...

    @abstractmethod
    def dump_to_str(self, obj, **kwargs):
        ...

    def load_from_path(self, filepath: str, mode: str = "r", **kwargs):
        with open(filepath, mode) as f:
            return self.load_from_fileobj(f, **kwargs)

    def dump_to_path(self, obj, filepath: str, mode: str = "w", **kwargs):
        with open(filepath, mode) as f:
            self.dump_to_fileobj(obj, f, **kwargs)


def _json_default(obj):
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, set):
        return list(obj)
    raise TypeError(f"Object of type {type(obj)} is not JSON serializable")


class JsonHandler(BaseFileHandler):
    def load_from_fileobj(self, file, **kwargs):
        return json.load(file, **kwargs)

    def dump_to_fileobj(self, obj, file, **kwargs):
        kwargs.setdefault("default", _json_default)
        json.dump(obj, file, **kwargs)

    def dump_to_str(self, obj, **kwargs):
        kwargs.setdefault("default", _json_default)
        return json.dumps(obj, **kwargs)


class YamlHandler(BaseFileHandler):
    def load_from_fileobj(self, file, **kwargs):
        kwargs.setdefault("Loader", yaml.SafeLoader)
        return yaml.load(file, **kwargs)

    def dump_to_fileobj(self, obj, file, **kwargs):
        kwargs.setdefault("Dumper", yaml.SafeDumper)
        yaml.dump(obj, file, **kwargs)

    def dump_to_str(self, obj, **kwargs):
        kwargs.setdefault("Dumper", yaml.SafeDumper)
        return yaml.dump(obj, **kwargs)


class PickleHandler(BaseFileHandler):
    str_like = False

    def load_from_fileobj(self, file, **kwargs):
        return pickle.load(file, **kwargs)

    def load_from_path(self, filepath, **kwargs):
        return super().load_from_path(filepath, mode="rb", **kwargs)

    def dump_to_str(self, obj, **kwargs):
        kwargs.setdefault("protocol", 2)
        return pickle.dumps(obj, **kwargs)

    def dump_to_fileobj(self, obj, file, **kwargs):
        kwargs.setdefault("protocol", 2)
        pickle.dump(obj, file, **kwargs)

    def dump_to_path(self, obj, filepath, **kwargs):
        super().dump_to_path(obj, filepath, mode="wb", **kwargs)
