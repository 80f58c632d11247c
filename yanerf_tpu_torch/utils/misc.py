"""Small generic helpers, as ``yanerf_tpu/utils/misc.py`` has them.

``import_modules_from_strings`` imports a config's ``custom_imports``
(``utils/config.py``).
"""

from __future__ import annotations

import collections.abc
import functools
import importlib
import itertools
from typing import Any, Optional, Sequence, Type


def is_str(x: Any) -> bool:
    return isinstance(x, str)


def is_seq_of(seq: Any, expected_type: Type, seq_type: Optional[Type] = None) -> bool:
    """Check whether ``seq`` is a sequence whose items are all ``expected_type``."""
    exp_seq_type = collections.abc.Sequence if seq_type is None else seq_type
    if not isinstance(seq, exp_seq_type):
        return False
    return all(isinstance(item, expected_type) for item in seq)


def is_list_of(seq: Any, expected_type: Type) -> bool:
    return is_seq_of(seq, expected_type, seq_type=list)


def is_tuple_of(seq: Any, expected_type: Type) -> bool:
    return is_seq_of(seq, expected_type, seq_type=tuple)


def iter_cast(inputs, dst_type: Type, return_type: Optional[Type] = None):
    """Cast elements of an iterable to ``dst_type``, optionally materialized."""
    if not isinstance(inputs, collections.abc.Iterable):
        raise TypeError("inputs must be an iterable object")
    out = map(dst_type, inputs)
    return out if return_type is None else return_type(out)


def list_cast(inputs, dst_type: Type) -> list:
    return iter_cast(inputs, dst_type, return_type=list)


def tuple_cast(inputs, dst_type: Type) -> tuple:
    return iter_cast(inputs, dst_type, return_type=tuple)


def slice_list(in_list: list, lens) -> list:
    """Slice a flat list into sublists of the given lengths."""
    if isinstance(lens, int):
        if len(in_list) % lens != 0:
            raise ValueError("list length is not evenly divisible")
        lens = [lens] * (len(in_list) // lens)
    if not isinstance(lens, list):
        raise TypeError('"lens" must be an int or list of ints')
    if sum(lens) != len(in_list):
        raise ValueError(f"sum of lens {sum(lens)} != list length {len(in_list)}")
    offsets = [0] + list(itertools.accumulate(lens))
    return [in_list[offsets[i]: offsets[i + 1]] for i in range(len(lens))]


def concat_list(in_list: Sequence[Sequence]) -> list:
    return list(itertools.chain.from_iterable(in_list))


def import_modules_from_strings(imports, allow_failed_imports: bool = False):
    """Import module(s) by dotted name(s)."""
    if not imports:
        return None
    single = False
    if isinstance(imports, str):
        single = True
        imports = [imports]
    if not is_list_of(imports, str):
        raise TypeError(f"imports must be a str or list of str, got {type(imports)}")
    imported = []
    for name in imports:
        try:
            imported.append(importlib.import_module(name))
        except ImportError:
            if allow_failed_imports:
                import warnings

                warnings.warn(f"{name} failed to import and is ignored.", UserWarning)
                imported.append(None)
            else:
                raise
    return imported[0] if single else imported


def _ntuple(n: int):
    def parse(x):
        if isinstance(x, collections.abc.Iterable):
            return tuple(x)
        return tuple(itertools.repeat(x, n))

    return parse


to_1tuple = _ntuple(1)
to_2tuple = _ntuple(2)
to_3tuple = _ntuple(3)
to_4tuple = _ntuple(4)
to_ntuple = _ntuple


def deprecated_api_warning(name_dict: dict, cls_name: Optional[str] = None):
    """Decorator mapping deprecated kwarg names to new ones with a warning."""

    def wrapper(old_func):
        @functools.wraps(old_func)
        def new_func(*args, **kwargs):
            import warnings

            func_name = old_func.__name__ if cls_name is None else f"{cls_name}.{old_func.__name__}"
            for src, dst in name_dict.items():
                if src in kwargs:
                    if dst in kwargs:
                        raise TypeError(f"{func_name} got both '{src}' (deprecated) and '{dst}'")
                    warnings.warn(f"'{src}' is deprecated in {func_name}, use '{dst}' instead", DeprecationWarning)
                    kwargs[dst] = kwargs.pop(src)
            return old_func(*args, **kwargs)

        return new_func

    return wrapper
