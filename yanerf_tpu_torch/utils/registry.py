"""String -> class registries, the framework's extension surface.

The port's own copy of ``yanerf_tpu/utils/registry.py``.

Mirrors the behavioural contract of the reference registry
(``yanerf/utils/registry.py`` of yet-another-nerf): named registries, a
``register_module`` decorator, hierarchical parent/child scoping, and
``build(cfg)`` which instantiates ``cfg.type`` with the remaining keys as
constructor kwargs, wrapping errors with the offending class name.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Optional, Type


def build_from_cfg(cfg: dict, registry: "Registry", default_args: Optional[dict] = None) -> Any:
    """Instantiate an object from a config dict with a ``type`` key."""
    if not isinstance(cfg, dict):
        raise TypeError(f"cfg must be a dict, got {type(cfg)}")
    if "type" not in cfg:
        if default_args is None or "type" not in default_args:
            raise KeyError(f'cfg must contain the key "type", got {cfg}')
    if not isinstance(registry, Registry):
        raise TypeError(f"registry must be a Registry, got {type(registry)}")

    args = dict(cfg)
    if default_args is not None:
        for name, value in default_args.items():
            args.setdefault(name, value)

    obj_type = args.pop("type")
    if isinstance(obj_type, str):
        obj_cls = registry.get(obj_type)
        if obj_cls is None:
            raise KeyError(f"{obj_type} is not in the {registry.name} registry")
    elif inspect.isclass(obj_type) or inspect.isfunction(obj_type):
        obj_cls = obj_type
    else:
        raise TypeError(f"type must be a str or class, got {type(obj_type)}")

    try:
        return obj_cls(**args)
    except Exception as e:
        raise type(e)(f"{obj_cls.__name__}: {e}") from e


class Registry:
    """A registry mapping strings to classes (or callables)."""

    def __init__(self, name: str, parent: Optional["Registry"] = None, scope: Optional[str] = None):
        self._name = name
        self._module_dict: Dict[str, Type] = {}
        self._children: Dict[str, "Registry"] = {}
        self._scope = scope if scope is not None else self._infer_scope()
        self.parent: Optional[Registry] = None
        if parent is not None:
            parent._add_child(self)
            self.parent = parent

    @staticmethod
    def _infer_scope() -> str:
        # The package name of the caller's caller, e.g. "yanerf_tpu_torch".
        frame = inspect.currentframe()
        try:
            caller = frame.f_back.f_back  # type: ignore[union-attr]
            module = inspect.getmodule(caller)
            if module is not None:
                return module.__name__.split(".")[0]
        finally:
            del frame
        return "yanerf_tpu_torch"

    def __len__(self) -> int:
        return len(self._module_dict)

    def __contains__(self, key: str) -> bool:
        return self.get(key) is not None

    def __repr__(self) -> str:
        return f"Registry(name={self._name}, items={list(self._module_dict)})"

    @property
    def name(self) -> str:
        return self._name

    @property
    def scope(self) -> str:
        return self._scope

    @property
    def module_dict(self) -> Dict[str, Type]:
        return self._module_dict

    @property
    def children(self) -> Dict[str, "Registry"]:
        return self._children

    @staticmethod
    def split_scope_key(key: str):
        index = key.find(".")
        if index != -1:
            return key[:index], key[index + 1:]
        return None, key

    def _add_child(self, registry: "Registry") -> None:
        if registry.scope in self._children:
            raise KeyError(f"scope {registry.scope} already exists in {self.name} registry")
        self._children[registry.scope] = registry

    def get(self, key: str) -> Optional[Type]:
        scope, real_key = self.split_scope_key(key)
        if scope is None or scope == self._scope:
            if real_key in self._module_dict:
                return self._module_dict[real_key]
        else:
            if scope in self._children:
                return self._children[scope].get(real_key)
            root = self
            while root.parent is not None:
                root = root.parent
            if root is not self:
                return root.get(key)
            # already at the root and the scope is unknown: an unguarded
            # root.get(key) would recurse into this same frame forever
        return None

    def build(self, cfg: dict, **default_args) -> Any:
        return build_from_cfg(cfg, self, default_args or None)

    def _register(self, module_class: Type, module_name=None, force: bool = False) -> None:
        if not (inspect.isclass(module_class) or inspect.isfunction(module_class)):
            raise TypeError(f"module must be a class or function, got {type(module_class)}")
        if module_name is None:
            module_name = module_class.__name__
        names = [module_name] if isinstance(module_name, str) else list(module_name)
        for name in names:
            if not force and name in self._module_dict:
                raise KeyError(f"{name} is already registered in {self.name}")
            self._module_dict[name] = module_class

    def register_module(self, name=None, force: bool = False, module: Optional[Type] = None) -> Callable:
        if module is not None:
            self._register(module, module_name=name, force=force)
            return module

        # bare-decorator slip: @REG.register_module (no parentheses) passes
        # the class as `name` — silently returning _decorator here would
        # rebind the class symbol to a closure and register nothing
        if name is not None and not isinstance(name, (str, list, tuple)):
            if inspect.isclass(name) or inspect.isfunction(name):
                self._register(name)
                return name
            raise TypeError(f"name must be a str/list of str, got {type(name)}")

        def _decorator(cls):
            self._register(cls, module_name=name, force=force)
            return cls

        return _decorator


def register_not_ported(registry: Registry, names) -> None:
    """Register placeholders that raise ``NotImplementedError`` when built.

    Configs name components the port has not reached yet; building one
    then says so, instead of a registry ``KeyError``.
    """
    for name in names:

        def _init(self, *args, _name=name, **kwargs):
            raise NotImplementedError(f"{_name} is not ported to yanerf_tpu_torch yet (see ROADMAP.md Queue 1)")

        registry.register_module(name=name, module=type(name, (), {"__init__": _init}))
