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


# How _enc treats a value, by its type (the order of the checks is the
# JAX package's: an IntEnum is an int and stays itself; a plain Enum
# becomes its value).  The per-type answers and the per-class field lists
# and decoders are cached: the store copies every object it reads and
# writes through to_dict/from_dict, so this is the control plane's hot
# loop.
_AS_IS, _ENUM, _BYTES, _DATACLASS, _SEQ, _MAP = range(6)
_KIND: dict[type, int] = {type(None): _AS_IS}
_FIELDS: dict[type, tuple] = {}
_DECODERS: dict[Any, Any] = {}
_PLANS: dict[type, tuple] = {}


def _kind(t: type) -> int:
    k = _KIND.get(t)
    if k is None:
        if issubclass(t, (int, float, str, bool)):
            k = _AS_IS
        elif issubclass(t, enum.Enum):
            k = _ENUM
        elif issubclass(t, bytes):
            k = _BYTES
        elif dataclasses.is_dataclass(t):
            k = _DATACLASS
        elif issubclass(t, (list, tuple)):
            k = _SEQ
        elif issubclass(t, dict):
            k = _MAP
        else:
            raise TypeError(f"cannot serialize {t!r}")
        _KIND[t] = k
    return k


def _field_names(cls: type) -> tuple:
    names = _FIELDS.get(cls)
    if names is None:
        names = _FIELDS[cls] = tuple(f.name for f in dataclasses.fields(cls))
    return names


def _enc(value: Any) -> Any:
    t = type(value)
    k = _KIND.get(t)
    if k is None:
        k = _kind(t)
    if k == _AS_IS:
        return value
    if k == _DATACLASS:
        out = {}
        for name in _field_names(t):
            v = getattr(value, name)
            if v is None:
                continue
            out[name] = _enc(v)
        return out
    if k == _SEQ:
        return [_enc(v) for v in value]
    if k == _MAP:
        return {str(key): _enc(v) for key, v in value.items()}
    if k == _ENUM:
        return value.value
    return {"__b64__": base64.b64encode(value).decode("ascii")}


def _dec(tp: Any, data: Any) -> Any:
    return _decoder(tp)(data)


def _decoder(tp: Any):
    """The function that decodes data of type hint `tp`, built once."""
    try:
        return _DECODERS[tp]
    except KeyError:
        pass
    except TypeError:          # an unhashable hint: build it every time
        return _build_decoder(tp)
    f = _DECODERS[tp] = _build_decoder(tp)
    return f


def _build_decoder(tp: Any):
    origin = get_origin(tp)
    if origin is Union:  # Optional[X]
        args = [a for a in get_args(tp) if a is not type(None)]
        inner = _decoder(args[0])
        return lambda data: None if data is None else inner(data)
    if origin in (list, tuple):
        args = get_args(tp) or (Any,)
        if len(args) != 1:
            def dec_fixed_tuple(data):
                if data is None:
                    return None
                (item_tp,) = args   # the generic decoder's ValueError
            return dec_fixed_tuple
        item = _decoder(args[0])
        return lambda data: None if data is None else [item(v) for v in data]
    if origin is dict:
        args = get_args(tp)
        value = _decoder(args[1] if len(args) == 2 else Any)
        return lambda data: None if data is None else {
            k: value(v) for k, v in data.items()}
    if isinstance(tp, type):
        if tp is bytes:
            def dec_bytes(data):
                if data is None:
                    return None
                if isinstance(data, dict) and "__b64__" in data:
                    return base64.b64decode(data["__b64__"])
                return bytes(data)
            return dec_bytes
        if issubclass(tp, enum.Enum) or tp in (int, float, str, bool):
            return lambda data: None if data is None else tp(data)
        if dataclasses.is_dataclass(tp):
            return lambda data: None if data is None else _from_dict(tp, data)
    return lambda data: data


def _from_dict(cls: type, data: dict) -> Any:
    plan = _PLANS.get(cls)
    if plan is None:
        hints = _hints(cls)
        plan = _PLANS[cls] = tuple((f.name, _decoder(hints[f.name]))
                                   for f in dataclasses.fields(cls))
    kwargs = {}
    for name, dec in plan:
        if name in data:
            kwargs[name] = dec(data[name])
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
