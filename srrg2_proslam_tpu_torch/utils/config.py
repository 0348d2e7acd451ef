"""Typed configurations: a registry by class name and a JSON round trip.

Port of srrg2_proslam_tpu/utils/config.py.  ``@register`` enters a frozen
dataclass in the registry under its class name; the port's config classes
carry the JAX package's class names, field names and defaults, so the
``configurations/*.json`` files written for the JAX package load into the
port as they are.  ``to_dict``/``from_dict`` recurse through nested
configs, tagging each object with ``"type"``; lists come back as tuples;
a key the class lacks raises KeyError.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
from typing import Any, Dict, Type

_REGISTRY: Dict[str, Type] = {}

# every module of the port that defines a registered config class
_CONFIG_MODULES = (
    "ops.features", "ops.matching", "ops.ekf", "ops.landmark_estimators", "ops.pgo",
    "ops.ba", "models.frontend", "models.tracker", "models.loop_closure", "models.slam",
)


def register(cls):
    """Class decorator: make a (frozen) dataclass JSON-instantiable by name."""
    if not dataclasses.is_dataclass(cls):
        cls = dataclasses.dataclass(frozen=True)(cls)
    _REGISTRY[cls.__name__] = cls
    return cls


def _ensure_registry_populated() -> None:
    """Import every config-bearing module, so that a process that imported
    only this module can resolve every type name."""
    package = __name__.rsplit(".", 2)[0]
    for mod in _CONFIG_MODULES:
        importlib.import_module(f"{package}.{mod}")


def registered(name: str) -> Type:
    if name not in _REGISTRY:
        _ensure_registry_populated()
    return _REGISTRY[name]


def registry() -> Dict[str, Type]:
    _ensure_registry_populated()
    return dict(_REGISTRY)


def to_dict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {"type": type(obj).__name__}
        for f in dataclasses.fields(obj):
            out[f.name] = to_dict(getattr(obj, f.name))
        return out
    if isinstance(obj, (list, tuple)):
        return [to_dict(v) for v in obj]
    if isinstance(obj, dict):
        return {k: to_dict(v) for k, v in obj.items()}
    return obj


def from_dict(data: Any) -> Any:
    if isinstance(data, dict) and "type" in data:
        cls = registered(data["type"])
        names = {f.name for f in dataclasses.fields(cls)}
        kwargs = {}
        for key, value in data.items():
            if key == "type":
                continue
            if key not in names:
                raise KeyError(f"{data['type']} has no config field {key!r}")
            kwargs[key] = from_dict(value)
        return cls(**kwargs)
    if isinstance(data, list):
        # JSON has no tuples; configs are frozen and hashable, so sequences
        # come back as tuples
        return tuple(from_dict(v) for v in data)
    if isinstance(data, dict):
        return {k: from_dict(v) for k, v in data.items()}
    return data


def save(obj: Any, path: str) -> None:
    with open(path, "w") as f:
        json.dump(to_dict(obj), f, indent=2)


def load(path: str) -> Any:
    with open(path) as f:
        return from_dict(json.load(f))


def replace(obj, **kwargs):
    """``dataclasses.replace`` passthrough (for tuned configs)."""
    return dataclasses.replace(obj, **kwargs)
