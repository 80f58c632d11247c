"""Pluggable storage backends, as ``yanerf_tpu/utils/fileio/backends.py`` has them.

Disk and HTTP (read-only) are built in; LMDB, Memcached, Petrel and Ceph
import their optional client package when constructed and raise an
``ImportError`` naming it when it is missing. ``FileClient.register_backend``
adds a backend and its URI prefixes without touching call sites.
"""

from __future__ import annotations

import os
import os.path as osp
from abc import ABCMeta, abstractmethod
from pathlib import Path
from typing import Any, Dict, Optional, Type, Union
from urllib.request import urlopen


class BaseStorageBackend(metaclass=ABCMeta):
    @abstractmethod
    def get(self, filepath: str) -> bytes:
        ...

    @abstractmethod
    def get_text(self, filepath: str, encoding: str = "utf-8") -> str:
        ...

    # writes are optional per backend (HTTP is read-only); a clear error
    # beats the AttributeError a missing method would raise from dump()
    def put(self, obj: bytes, filepath) -> None:
        raise NotImplementedError(f"{type(self).__name__} does not support writing")

    def put_text(self, obj: str, filepath, encoding: str = "utf-8") -> None:
        raise NotImplementedError(f"{type(self).__name__} does not support writing")


class HardDiskBackend(BaseStorageBackend):
    def get(self, filepath: Union[str, Path]) -> bytes:
        with open(filepath, "rb") as f:
            return f.read()

    def get_text(self, filepath: Union[str, Path], encoding: str = "utf-8") -> str:
        with open(filepath, encoding=encoding) as f:
            return f.read()

    def put(self, obj: bytes, filepath: Union[str, Path]) -> None:
        os.makedirs(osp.dirname(osp.abspath(str(filepath))), exist_ok=True)
        with open(filepath, "wb") as f:
            f.write(obj)

    def put_text(self, obj: str, filepath: Union[str, Path], encoding: str = "utf-8") -> None:
        os.makedirs(osp.dirname(osp.abspath(str(filepath))), exist_ok=True)
        with open(filepath, "w", encoding=encoding) as f:
            f.write(obj)

    def exists(self, filepath: Union[str, Path]) -> bool:
        return osp.exists(filepath)

    def isfile(self, filepath: Union[str, Path]) -> bool:
        return osp.isfile(filepath)

    def isdir(self, filepath: Union[str, Path]) -> bool:
        return osp.isdir(filepath)


class HTTPBackend(BaseStorageBackend):
    def get(self, filepath: str) -> bytes:
        with urlopen(filepath) as resp:
            return resp.read()

    def get_text(self, filepath: str, encoding: str = "utf-8") -> str:
        return self.get(filepath).decode(encoding)


class LmdbBackend(BaseStorageBackend):
    """LMDB key-value storage (requires the optional ``lmdb`` package)."""

    def __init__(self, db_path: str, readonly: bool = True, lock: bool = False, readahead: bool = False, **kwargs):
        try:
            import lmdb
        except ImportError as e:
            raise ImportError("Please install lmdb to enable LmdbBackend.") from e
        self.db_path = str(db_path)
        self._client = lmdb.open(self.db_path, readonly=readonly, lock=lock, readahead=readahead, **kwargs)

    def get(self, filepath: str) -> bytes:
        with self._client.begin(write=False) as txn:
            return txn.get(str(filepath).encode("ascii"))

    def get_text(self, filepath: str, encoding: str = "utf-8") -> str:
        return self.get(filepath).decode(encoding)


class MemcachedBackend(BaseStorageBackend):
    """Memcached storage (requires the optional ``pymemcache`` package)."""

    def __init__(self, server: str = "127.0.0.1:11211", **kwargs):
        try:
            from pymemcache.client.base import Client
        except ImportError as e:
            raise ImportError("Please install pymemcache to enable MemcachedBackend.") from e
        host, _, port = server.partition(":")
        self._client = Client((host, int(port or 11211)), **kwargs)

    def get(self, filepath: str) -> bytes:
        return self._client.get(str(filepath))

    def get_text(self, filepath: str, encoding: str = "utf-8") -> str:
        return self.get(filepath).decode(encoding)


class PetrelBackend(BaseStorageBackend):
    """Petrel/Ceph object storage (requires the optional ``petrel_client``)."""

    def __init__(self, enable_mc: bool = True, **kwargs):
        try:
            from petrel_client import client
        except ImportError as e:
            raise ImportError("Please install petrel_client to enable PetrelBackend.") from e
        self._client = client.Client(enable_mc=enable_mc, **kwargs)

    def get(self, filepath: str) -> bytes:
        return memoryview(self._client.Get(str(filepath))).tobytes()

    def get_text(self, filepath: str, encoding: str = "utf-8") -> str:
        return self.get(filepath).decode(encoding)


class CephBackend(BaseStorageBackend):
    """Ceph S3 storage (requires the optional ``ceph`` package).

    Completes the reference's storage matrix (ref
    yanerf/utils/fileio/file_client.py:47-76). ``path_mapping`` rewrites
    path prefixes before the fetch, matching the reference semantics.
    """

    def __init__(self, path_mapping: Optional[Dict[str, str]] = None):
        try:
            import ceph
        except ImportError as e:
            raise ImportError("Please install ceph to enable CephBackend.") from e
        self._client = ceph.S3Client()
        if path_mapping is not None and not isinstance(path_mapping, dict):
            raise TypeError(f"path_mapping must be a dict or None, got {type(path_mapping)}")
        self.path_mapping = path_mapping

    def _map(self, filepath: str) -> str:
        if self.path_mapping is not None:
            for src, dst in self.path_mapping.items():
                filepath = filepath.replace(src, dst)
        return filepath

    def get(self, filepath: str) -> bytes:
        return memoryview(self._client.Get(self._map(str(filepath)))).tobytes()

    def get_text(self, filepath: str, encoding: str = "utf-8") -> str:
        return self.get(filepath).decode(encoding)


class FileClient:
    """Dispatches file access to a storage backend chosen by name or prefix."""

    _backends: Dict[str, Type[BaseStorageBackend]] = {
        "disk": HardDiskBackend,
        "http": HTTPBackend,
        "lmdb": LmdbBackend,
        "memcached": MemcachedBackend,
        "petrel": PetrelBackend,
        "ceph": CephBackend,
    }
    _prefix_to_backend: Dict[str, str] = {
        "http": "http",
        "https": "http",
        "s3": "petrel",
        "petrel": "petrel",
    }

    def __init__(self, backend: str = "disk", **kwargs: Any):
        if backend not in self._backends:
            raise ValueError(f"Backend {backend} is not supported; registered: {list(self._backends)}")
        self.backend_name = backend
        self.client = self._backends[backend](**kwargs)

    @classmethod
    def infer_client(cls, uri: Optional[Union[str, Path]] = None) -> "FileClient":
        if uri is None:
            return cls("disk")
        prefix = cls.parse_uri_prefix(str(uri))
        if prefix is None:
            return cls("disk")
        return cls(cls._prefix_to_backend.get(prefix, "disk"))

    @staticmethod
    def parse_uri_prefix(uri: str) -> Optional[str]:
        if "://" not in uri:
            return None
        return uri.split("://", 1)[0]

    @classmethod
    def register_backend(cls, name: str, backend: Type[BaseStorageBackend], prefixes=None, force: bool = False):
        if not force and name in cls._backends:
            raise KeyError(f"Backend {name} is already registered")
        cls._backends[name] = backend
        if prefixes is not None:
            if isinstance(prefixes, str):
                prefixes = [prefixes]
            for prefix in prefixes:
                cls._prefix_to_backend[prefix] = name

    def get(self, filepath) -> bytes:
        return self.client.get(filepath)

    def get_text(self, filepath, encoding: str = "utf-8") -> str:
        return self.client.get_text(filepath, encoding)

    def put(self, obj: bytes, filepath) -> None:
        return self.client.put(obj, filepath)

    def put_text(self, obj: str, filepath, encoding: str = "utf-8") -> None:
        return self.client.put_text(obj, filepath, encoding)
