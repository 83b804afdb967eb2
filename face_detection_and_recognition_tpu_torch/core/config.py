"""Config layer: every runtime config dataclass serializes to and from JSON.

The port's copy of ``core/config.py`` in the JAX package: a CLI flag file, a
service deployment config and a pipeline job spec share one format, and a
file written by either package's ``save_config`` loads in the other. A
``dtype`` field maps to a ``torch`` dtype (``as_dtype``).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Type, TypeVar

import torch

T = TypeVar("T")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def as_dtype(v: Any) -> torch.dtype:
    """A ``torch`` dtype, from one or from its name in any spelling
    ``to_dict`` writes: "float32", "torch.float32", or the JAX package's
    "<class 'jax.numpy.float32'>"."""
    if isinstance(v, torch.dtype):
        return v
    name = str(v).split(".")[-1].replace("'>", "")
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype {v!r}: one of {sorted(_DTYPES)}")
    return _DTYPES[name]


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
            v = as_dtype(v)
        kwargs[k] = v
    return cls(**kwargs)
