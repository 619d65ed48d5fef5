"""``_target_``-driven instantiation (counterpart of
sheeprl_tpu/config/instantiate.py, itself ``hydra.utils.instantiate`` as the
reference uses it): a config node with a ``_target_`` names a callable by
dotted path and its other keys are the keyword arguments; ``_partial_:
true`` returns a ``functools.partial`` instead of calling it."""

from __future__ import annotations

import functools
import importlib
from typing import Any, Mapping


def locate(path: str) -> Any:
    """The object at a dotted path (``module.attr[.attr...]``)."""
    parts = path.split(".")
    for split in range(len(parts) - 1, 0, -1):
        module_name = ".".join(parts[:split])
        try:
            module = importlib.import_module(module_name)
        except ModuleNotFoundError as e:
            # Only "this prefix is not a module" is passed over. A missing
            # dependency of a module that exists, or a module that raises a
            # plain ImportError, is an error the user must see.
            if e.name is not None and not (module_name == e.name or module_name.startswith(e.name + ".")):
                raise
            continue
        obj = module
        try:
            for attr in parts[split:]:
                obj = getattr(obj, attr)
        except AttributeError:
            continue
        return obj
    raise ImportError(f"Cannot locate object at dotted path: '{path}'")


def _instantiate_children(value: Any) -> Any:
    """Instantiate every ``_target_`` node of a subtree."""
    if isinstance(value, Mapping):
        if "_target_" in value:
            return instantiate(value)
        return {k: _instantiate_children(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_instantiate_children(v) for v in value)
    return value


def instantiate(node: Any, *args: Any, **overrides: Any) -> Any:
    """Call the ``_target_`` of ``node`` with ``args``, its other keys (nested
    ``_target_`` nodes instantiated first) and ``overrides``; a node without
    a ``_target_`` is returned as it is."""
    if isinstance(node, Mapping) and "_target_" in node:
        kwargs = {}
        partial = False
        target = None
        for k, v in node.items():
            if k == "_target_":
                target = v
            elif k == "_partial_":
                partial = bool(v)
            elif k.startswith("_"):
                continue
            else:
                kwargs[k] = _instantiate_children(v)
        kwargs.update(overrides)
        fn = locate(target)
        if partial:
            return functools.partial(fn, *args, **kwargs)
        return fn(*args, **kwargs)
    if overrides or args:
        raise ValueError("Cannot pass args/kwargs when instantiating a non-_target_ node")
    return node
