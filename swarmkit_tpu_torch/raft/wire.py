"""Binary wire codec for raft protocol messages and conf-change entries
(the PyTorch port's counterpart of the JAX package's raft/wire.py).

The device-mesh transport moves raft messages through fixed-width int32
mailbox arrays; it needs a compact, versioned, CODE-FREE encoding — a
replay must never execute anything (the reference wire/WAL format is
protobuf raftpb, vendor/github.com/coreos/etcd/raft/raftpb).  The JAX
package packs positional tuples with msgpack.  The port carries its own
encoder and decoder for the subset those tuples use (ints, bools, None,
bytes, str, lists and tuples), byte for byte msgpack's: ``packb`` with its
defaults and ``unpackb`` with ``raw=False``, so a message encoded by one
package decodes in the other.  Maps, floats and extension types are not in
the subset and raise.
"""

from __future__ import annotations

import struct

from swarmkit_tpu_torch.raft.messages import (
    ConfChange, ConfChangeType, Entry, EntryType, Message, MsgType, Snapshot,
    SnapshotMeta,
)

WIRE_VERSION = 1

# (first byte, struct format) of the sized forms, smallest first
_UINTS = ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16), (0xce, ">I", 1 << 32),
          (0xcf, ">Q", 1 << 64))
_INTS = ((0xd0, ">b", 1 << 7), (0xd1, ">h", 1 << 15), (0xd2, ">i", 1 << 31),
         (0xd3, ">q", 1 << 63))
_LENS = {1: ">B", 2: ">H", 4: ">I"}


def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80:
        out.append(v)
        return
    if -32 <= v < 0:
        out.append(v & 0xff)
        return
    for head, fmt, lim in (_UINTS if v >= 0 else _INTS):
        if (v < lim) if v >= 0 else (v >= -lim):
            out.append(head)
            out += struct.pack(fmt, v)
            return
    raise OverflowError(f"integer {v} does not fit 64 bits")


def _pack_sized(n: int, small, heads: tuple, out: bytearray) -> None:
    """The header of a str, bin or array of length n: the fixed form
    `small` (first byte, limit) when given and n fits it, else the first
    of `heads` ((first byte, width in bytes)) that holds n."""
    if small is not None and n < small[1]:
        out.append(small[0] | n)
        return
    for head, width in heads:
        if n < 1 << (8 * width):
            out.append(head)
            out += struct.pack(_LENS[width], n)
            return
    raise ValueError(f"length {n} does not fit 32 bits")


def _pack(v, out: bytearray) -> None:
    if v is None:
        out.append(0xc0)
    elif v is True or v is False:
        out.append(0xc3 if v else 0xc2)
    elif isinstance(v, int):
        _pack_int(int(v), out)
    elif isinstance(v, (bytes, bytearray, memoryview)):
        v = bytes(v)
        _pack_sized(len(v), None, ((0xc4, 1), (0xc5, 2), (0xc6, 4)), out)
        out += v
    elif isinstance(v, str):
        b = v.encode("utf-8")
        _pack_sized(len(b), (0xa0, 32), ((0xd9, 1), (0xda, 2), (0xdb, 4)),
                    out)
        out += b
    elif isinstance(v, (list, tuple)):
        _pack_sized(len(v), (0x90, 16), ((0xdc, 2), (0xdd, 4)), out)
        for item in v:
            _pack(item, out)
    else:
        raise TypeError(f"cannot encode {type(v).__name__} on the raft wire")


def packb(v) -> bytes:
    """msgpack.packb(v) for the codec's subset."""
    out = bytearray()
    _pack(v, out)
    return bytes(out)


class _Reader:
    def __init__(self, raw: bytes) -> None:
        self.raw = memoryview(bytes(raw))
        self.pos = 0

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.raw):
            raise ValueError("truncated raft wire payload")
        b = self.raw[self.pos:end].tobytes()
        self.pos = end
        return b

    def unpack(self, fmt: str) -> int:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        head = self.take(1)[0]
        if head < 0x80:
            return head
        if head >= 0xe0:
            return head - 0x100
        if 0x90 <= head <= 0x9f:
            return self.array(head & 0x0f)
        if 0xa0 <= head <= 0xbf:
            return self.take(head & 0x1f).decode("utf-8")
        if head == 0xc0:
            return None
        if head in (0xc2, 0xc3):
            return head == 0xc3
        for table in (_UINTS, _INTS):
            for h, fmt, _ in table:
                if head == h:
                    return self.unpack(fmt)
        sized = {0xc4: (1, "bin"), 0xc5: (2, "bin"), 0xc6: (4, "bin"),
                 0xd9: (1, "str"), 0xda: (2, "str"), 0xdb: (4, "str"),
                 0xdc: (2, "array"), 0xdd: (4, "array")}.get(head)
        if sized is None:
            raise ValueError(f"raft wire byte 0x{head:02x} is not in the "
                             "codec's subset")
        n = self.unpack(_LENS[sized[0]])
        if sized[1] == "array":
            return self.array(n)
        b = self.take(n)
        return b if sized[1] == "bin" else b.decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]


def unpackb(raw: bytes):
    """msgpack.unpackb(raw) for the codec's subset (arrays come back as
    lists, bin as bytes, str as str); trailing bytes raise, as there."""
    r = _Reader(raw)
    v = r.value()
    if r.pos != len(r.raw):
        raise ValueError("extra bytes after the raft wire payload")
    return v


def encode_conf_change(cc: ConfChange) -> bytes:
    return packb((WIRE_VERSION, cc.id, int(cc.type), cc.node_id, cc.context))


def decode_conf_change(raw: bytes) -> ConfChange:
    """Strict decode; anything else fails loudly rather than deserializing
    arbitrary payloads from the log."""
    try:
        fields = unpackb(raw)
        ver, cc_id, cc_type, node_id, context = fields
        if ver != WIRE_VERSION:
            raise ValueError(f"version {ver}")
    except Exception as e:
        raise ValueError(
            "undecodable ConfChange entry (legacy/pickled WAL formats are "
            f"not supported; re-bootstrap the member): {e}") from e
    return ConfChange(id=cc_id, type=ConfChangeType(cc_type),
                      node_id=node_id, context=context)


def encode_message(m: Message) -> bytes:
    ents = [(e.index, e.term, int(e.type), e.data) for e in m.entries]
    snap = None
    if m.snapshot is not None:
        meta = m.snapshot.meta
        snap = (meta.index, meta.term, list(meta.voters), m.snapshot.data)
    return packb((
        WIRE_VERSION, int(m.type), m.to, m.frm, m.term, m.log_term, m.index,
        ents, m.commit, m.reject, m.reject_hint, snap, m.context,
    ))


def decode_message(raw: bytes) -> Message:
    (ver, mtype, to, frm, term, log_term, index, ents, commit, reject,
     reject_hint, snap, context) = unpackb(raw)
    if ver != WIRE_VERSION:
        raise ValueError(f"unsupported raft wire version {ver}")
    snapshot = None
    if snap is not None:
        sidx, sterm, voters, data = snap
        snapshot = Snapshot(meta=SnapshotMeta(index=sidx, term=sterm,
                                              voters=tuple(voters)),
                            data=data)
    return Message(
        type=MsgType(mtype), to=to, frm=frm, term=term, log_term=log_term,
        index=index,
        entries=tuple(Entry(index=i, term=t, type=EntryType(ty), data=d)
                      for i, t, ty, d in ents),
        commit=commit, reject=reject, reject_hint=reject_hint,
        snapshot=snapshot, context=context,
    )
