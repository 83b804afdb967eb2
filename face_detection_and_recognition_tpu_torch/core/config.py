"""Config layer: every runtime config dataclass serializes to and from JSON.

The port's copy of ``core/config.py`` in the JAX package: a CLI flag file, a
service deployment config and a pipeline job spec share one format. A
``dtype`` field maps to a ``torch`` dtype (the port's ``EngineConfig`` has
none yet).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Type, TypeVar

import torch

T = TypeVar("T")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def to_dict(cfg: Any) -> Dict[str, Any]:
    """Dataclass -> plain dict (non-serializable leaves stringified)."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            v = to_dict(v)
        elif not isinstance(v, (int, float, str, bool, list, tuple, dict,
                                type(None))):
            v = str(v)
        out[f.name] = v
    return out


def save_config(cfg: Any, path: str) -> None:
    with open(path, "w") as f:
        json.dump(to_dict(cfg), f, indent=2)


def load_config(cls: Type[T], path: str, **overrides) -> T:
    """JSON -> dataclass; unknown keys rejected, tuples restored, overrides
    applied last."""
    with open(path) as f:
        data = json.load(f)
    data.update(overrides)
    names = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(data) - set(names)
    if unknown:
        raise ValueError(f"unknown config keys for {cls.__name__}: "
                         f"{sorted(unknown)}")
    kwargs = {}
    for k, v in data.items():
        default = names[k].default
        if isinstance(default, tuple) and isinstance(v, list):
            v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
        if k == "dtype" and isinstance(v, str):
            # "torch.bfloat16" (to_dict's str of a dtype) or "bfloat16"
            v = _DTYPES.get(v.split(".")[-1], torch.float32)
        kwargs[k] = v
    return cls(**kwargs)
