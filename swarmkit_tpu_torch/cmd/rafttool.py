"""swarm-rafttool: offline decrypt + dump of raft WAL segments and
snapshots.

Reference: cmd/swarm-rafttool (main.go:19, dump.go) — dump-wal, dump-snapshot,
dump-object against a stopped node's state dir, decrypting with the node's
DEK.

The port's own copy of the JAX package's cmd/rafttool.py, plus the DEK: a
node with a TLS identity encrypts its WAL and snapshots with the raft DEK
kept in the headers of its key file (``<state-dir>/certificates/
swarm-node.key``), and the tool decrypts with it, as the reference's
does.  A state dir without a key file is read as plaintext, as the JAX
package reads it; a key file locked by autolock is refused with the key
file's own error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from swarmkit_tpu_torch.raft.messages import EntryType
from swarmkit_tpu_torch.raft.storage import EncryptedRaftLogger


def _logger(state_dir: str) -> EncryptedRaftLogger:
    """The node's raft storage, decrypting with every DEK generation its
    key file holds (reference: rafttool's getDEKData via the node's
    KeyReadWriter)."""
    cert_dir = os.path.join(state_dir, "certificates")
    if not os.path.exists(os.path.join(cert_dir, "swarm-node.key")):
        return EncryptedRaftLogger(state_dir)
    from swarmkit_tpu_torch.ca.keyreadwriter import KeyReadWriter
    from swarmkit_tpu_torch.encryption.encryption import (
        MultiDecrypter, SecretboxCrypter,
    )

    dek, history = KeyReadWriter(cert_dir).get_raft_deks()
    keys = [k for k in [dek, *history] if k]
    if not keys:
        return EncryptedRaftLogger(state_dir)
    return EncryptedRaftLogger(state_dir, decrypter=MultiDecrypter(
        *(SecretboxCrypter(k) for k in keys)))


def dump_wal(state_dir: str, out=sys.stdout) -> int:
    """Decode every entry in the WAL (reference: dump.go dumpWAL)."""
    lg = _logger(state_dir)
    result = lg.bootstrap_from_disk()
    count = 0
    for e in result.entries:
        rec = {"index": e.index, "term": e.term,
               "type": EntryType(e.type).name}
        if e.type == EntryType.NORMAL and e.data:
            try:
                from swarmkit_tpu_torch.api.raft_msgs import InternalRaftRequest

                req = InternalRaftRequest.decode(e.data)
                rec["request"] = req.to_dict()
            except Exception:
                rec["data_bytes"] = len(e.data)
        elif e.data:
            rec["data_bytes"] = len(e.data)
        json.dump(rec, out, default=str)
        out.write("\n")
        count += 1
    print(f"dumped {count} entries", file=sys.stderr)
    return 0


def dump_snapshot(state_dir: str, out=sys.stdout) -> int:
    """reference: dump.go dumpSnapshot."""
    lg = _logger(state_dir)
    result = lg.bootstrap_from_disk()
    if result.snapshot is None:
        print("no snapshot", file=sys.stderr)
        return 1
    snap = result.snapshot
    rec = {"index": snap.meta.index, "term": snap.meta.term,
           "data_bytes": len(snap.data)}
    try:
        from swarmkit_tpu_torch.api.raft_msgs import Snapshot as ApiSnapshot

        payload = ApiSnapshot.decode(snap.data)
        rec["payload_type"] = type(payload).__name__
        rec["version"] = payload.version
        rec["members"] = len(payload.membership.members)
    except Exception:
        pass
    json.dump(rec, out, default=str)
    out.write("\n")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="swarm-rafttool")
    p.add_argument("--state-dir", required=True)
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("dump-wal")
    sub.add_parser("dump-snapshot")
    args = p.parse_args(argv)
    if args.cmd == "dump-wal":
        return dump_wal(args.state_dir)
    return dump_snapshot(args.state_dir)


if __name__ == "__main__":
    raise SystemExit(main())
