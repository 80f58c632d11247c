"""Unified load/dump over pluggable backends, as ``yanerf_tpu/utils/fileio`` has them."""

from __future__ import annotations

import io
from pathlib import Path
from typing import Any, Optional, Union

from .backends import BaseStorageBackend, FileClient, HardDiskBackend, HTTPBackend
from .handlers import BaseFileHandler, JsonHandler, PickleHandler, YamlHandler

file_handlers = {
    "json": JsonHandler(),
    "yaml": YamlHandler(),
    "yml": YamlHandler(),
    "pickle": PickleHandler(),
    "pkl": PickleHandler(),
}


def register_handler(handler: BaseFileHandler, file_formats) -> None:
    if isinstance(file_formats, str):
        file_formats = [file_formats]
    for fmt in file_formats:
        file_handlers[fmt] = handler


def load(file: Union[str, Path, io.IOBase], file_format: Optional[str] = None, **kwargs) -> Any:
    """Load data from json/yaml/pickle files, local or remote (http)."""
    if isinstance(file, Path):
        file = str(file)
    if file_format is None and isinstance(file, str):
        file_format = file.split(".")[-1]
    if file_format not in file_handlers:
        raise TypeError(f"Unsupported format: {file_format}")

    handler = file_handlers[file_format]
    if isinstance(file, str):
        client = FileClient.infer_client(file)
        if client.backend_name == "disk":
            return handler.load_from_path(file, **kwargs)
        data = client.get(file)
        stream: io.IOBase = io.StringIO(data.decode("utf-8")) if handler.str_like else io.BytesIO(data)
        return handler.load_from_fileobj(stream, **kwargs)
    if hasattr(file, "read"):
        return handler.load_from_fileobj(file, **kwargs)
    raise TypeError('"file" must be a filepath str or a file-object')


def dump(obj: Any, file: Union[str, Path, io.IOBase, None] = None, file_format: Optional[str] = None, **kwargs):
    """Dump data to a string or json/yaml/pickle file."""
    if isinstance(file, Path):
        file = str(file)
    if file_format is None:
        if isinstance(file, str):
            file_format = file.split(".")[-1]
        elif file is None:
            raise ValueError("file_format must be specified when file is None")
    if file_format not in file_handlers:
        raise TypeError(f"Unsupported format: {file_format}")

    handler = file_handlers[file_format]
    if file is None:
        return handler.dump_to_str(obj, **kwargs)
    if isinstance(file, str):
        # route through the storage-backend dispatch symmetrically with
        # load(): a remote URI (http, petrel, ...) must hit its backend's
        # put(), not a local open()
        client = FileClient.infer_client(file)
        if client.backend_name == "disk":
            handler.dump_to_path(obj, file, **kwargs)
        else:
            data = handler.dump_to_str(obj, **kwargs)
            if handler.str_like:
                client.put_text(data, file)
            else:
                client.put(data, file)
        return None
    if hasattr(file, "write"):
        handler.dump_to_fileobj(obj, file, **kwargs)
        return None
    raise TypeError('"file" must be a filename str or a file-object')


__all__ = [
    "load",
    "dump",
    "register_handler",
    "file_handlers",
    "FileClient",
    "BaseStorageBackend",
    "HardDiskBackend",
    "HTTPBackend",
    "BaseFileHandler",
    "JsonHandler",
    "YamlHandler",
    "PickleHandler",
]
