"""Dataclass messages with generic (de)serialization.

The port's own copy of the JAX package's api/serde.py: every API type of
the port derives ``Message`` and gets ``to_dict``/``from_dict``/``copy``/
``encode``/``decode``/``fingerprint``.  The wire format is canonical JSON
(stable key order).  The scheduler groups tasks by their spec's encoding
and keys failure taints by its fingerprint, as the JAX package does.
"""

from __future__ import annotations

import base64
import dataclasses
import enum
import hashlib
import json
import sys
import typing
from typing import Any, Optional, Union, get_args, get_origin

_HINTS_CACHE: dict[type, dict[str, Any]] = {}


def _resolve_refs(tp: Any, globalns: dict) -> Any:
    """Resolve forward references `get_type_hints` leaves behind.

    Quoted args inside builtin generics — ``list["PortConfig"]`` — survive
    hint resolution as bare strings (the subscript value is never
    evaluated), so decoding would silently hand back raw dicts instead of
    rehydrated dataclasses.  Walk the hint tree and look such strings up in
    the defining module's namespace.
    """
    if isinstance(tp, str):
        return globalns.get(tp, tp)
    if type(tp) is typing.ForwardRef:
        return globalns.get(tp.__forward_arg__, tp)
    origin = get_origin(tp)
    if origin is None:
        return tp
    args = get_args(tp)
    new = tuple(_resolve_refs(a, globalns) for a in args)
    if new == args:
        return tp
    if origin is Union:
        return Union[new]
    return origin[new]


def _hints(cls: type) -> dict[str, Any]:
    h = _HINTS_CACHE.get(cls)
    if h is None:
        g = vars(sys.modules.get(cls.__module__, typing)) \
            if cls.__module__ in sys.modules else {}
        h = {k: _resolve_refs(v, g)
             for k, v in typing.get_type_hints(cls).items()}
        _HINTS_CACHE[cls] = h
    return h


def _enc(value: Any) -> Any:
    if value is None or isinstance(value, (int, float, str, bool)):
        return value
    if isinstance(value, enum.Enum):
        return value.value
    if isinstance(value, bytes):
        return {"__b64__": base64.b64encode(value).decode("ascii")}
    if dataclasses.is_dataclass(value):
        out = {}
        for f in dataclasses.fields(value):
            v = getattr(value, f.name)
            if v is None:
                continue
            out[f.name] = _enc(v)
        return out
    if isinstance(value, (list, tuple)):
        return [_enc(v) for v in value]
    if isinstance(value, dict):
        return {str(k): _enc(v) for k, v in value.items()}
    raise TypeError(f"cannot serialize {type(value)!r}")


def _dec(tp: Any, data: Any) -> Any:
    if data is None:
        return None
    origin = get_origin(tp)
    if origin is Union:  # Optional[X]
        args = [a for a in get_args(tp) if a is not type(None)]
        return _dec(args[0], data)
    if origin in (list, tuple):
        (item_tp,) = get_args(tp) or (Any,)
        return [_dec(item_tp, v) for v in data]
    if origin is dict:
        args = get_args(tp)
        item_tp = args[1] if len(args) == 2 else Any
        return {k: _dec(item_tp, v) for k, v in data.items()}
    if isinstance(tp, type):
        if tp is bytes:
            if isinstance(data, dict) and "__b64__" in data:
                return base64.b64decode(data["__b64__"])
            return bytes(data)
        if issubclass(tp, enum.Enum):
            return tp(data)
        if dataclasses.is_dataclass(tp):
            return _from_dict(tp, data)
        if tp in (int, float, str, bool):
            return tp(data)
    return data


def _from_dict(cls: type, data: dict) -> Any:
    hints = _hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name in data:
            kwargs[f.name] = _dec(hints[f.name], data[f.name])
    return cls(**kwargs)


class Message:
    """Mixin for API dataclasses: serialization, deep copy, canonical bytes."""

    def to_dict(self) -> dict:
        return _enc(self)

    @classmethod
    def from_dict(cls, data: dict):
        return _from_dict(cls, data)

    def copy(self):
        return _from_dict(type(self), _enc(self))

    def encode(self) -> bytes:
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":")).encode()

    def fingerprint(self) -> int:
        """Stable fingerprint of the canonical encoding — plays the
        reference's SpecVersion role wherever spec-change detection is
        needed (restart history, scheduler failure taints).  blake2b, not
        hash(): str/bytes hashing is salted per process
        (PYTHONHASHSEED), and these fingerprints outlive a process via
        WAL/snapshot restore and cross-manager comparison."""
        return int.from_bytes(
            hashlib.blake2b(self.encode(), digest_size=8).digest(), "big")

    @classmethod
    def decode(cls, raw: bytes):
        return cls.from_dict(json.loads(raw.decode()))
