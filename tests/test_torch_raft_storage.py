"""The port's raft persistence against the JAX package's: the WAL frame
codec (native/), the encrypted raft logger (raft/storage.py) and at-rest
encryption (encryption/).

- The codec cases of tests/test_native.py through the port's compiled
  codec and its plain version; the compiled codec equals the plain one,
  and the JAX package's, on the same frames, on every truncation of a
  stream (torn tails) and on corruption in the middle of one.
- The host WAL cases of tests/test_durability.py (a torn tail dropped on
  bootstrap, mid-file corruption refused) in both packages.
- A logger of one package writes entries, a hard state, a snapshot and
  a DEK rotation; the other package's logger bootstraps the same entries,
  hard state and snapshot, both ways.
- Encryption in both branches the packages choose at import: with
  ``cryptography`` here, and with it blocked in a subprocess (the
  stand-in AEAD, which the JAX package defines only where the import
  fails).  In each branch the port's records decrypt with the JAX
  package's and the reverse; a record of one branch does not decrypt in
  the other.
"""

from __future__ import annotations

import glob
import json
import os
import random
import struct
import subprocess
import sys
import zlib

import pytest

from swarmkit_tpu import encryption as jenc
from swarmkit_tpu.native import PyWalCodec as JaxPyWalCodec
from swarmkit_tpu.raft import messages as jmsg
from swarmkit_tpu.raft import storage as jstorage
from swarmkit_tpu_torch import encryption as tenc
from swarmkit_tpu_torch import native
from swarmkit_tpu_torch.raft import messages as tmsg
from swarmkit_tpu_torch.raft import storage as tstorage

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CODECS = ["native", "python"]


@pytest.fixture(scope="module")
def codecs():
    return {name: native.wal_codec(name) for name in CODECS}


def test_native_codec_builds_into_the_build_tree(codecs):
    assert codecs["native"].name == "native"
    assert native.LIB.exists()
    assert native.LIB.parent == native.BUILD_DIR
    assert os.path.relpath(native.BUILD_DIR, ROOT) == os.path.join(
        "build", "native")
    assert native.wal_codec("native") is codecs["native"]
    with pytest.raises(ValueError, match="unknown WAL codec"):
        native.wal_codec("fallback")


def test_a_failed_build_raises(monkeypatch, tmp_path):
    """A build that fails is the caller's error: no codec is handed out
    in its place."""
    bad = tmp_path / "wal_codec.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "LIB", tmp_path / "build" / "lib.so")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()


@pytest.mark.parametrize("name", CODECS)
def test_frame_scan_round_trip(codecs, name):
    codec = codecs[name]
    rng = random.Random(5)
    bodies = [rng.randbytes(rng.randint(0, 2048)) for _ in range(200)]
    blob = codec.frame(bodies)
    assert codec.scan(blob) == (bodies, native.STATUS_OK)


@pytest.mark.parametrize("name", CODECS)
def test_torn_tail_dropped(codecs, name):
    codec = codecs[name]
    blob = codec.frame([b"alpha", b"beta", b"gamma"])
    assert codec.scan(blob[:-3]) == ([b"alpha", b"beta"],
                                     native.STATUS_TORN_TAIL)
    cut = len(codec.frame([b"alpha"])) + 4   # mid-header
    assert codec.scan(blob[:cut]) == ([b"alpha"], native.STATUS_TORN_TAIL)


@pytest.mark.parametrize("name", CODECS)
def test_corrupt_midstream_detected(codecs, name):
    codec = codecs[name]
    blob = bytearray(codec.frame([b"alpha", b"beta", b"gamma"]))
    blob[9] ^= 0xFF
    assert codec.scan(bytes(blob)) == ([], native.STATUS_CORRUPT)


def test_native_equals_plain_and_jax(codecs):
    """The compiled codec's frames and scans equal the plain version's
    and the JAX package's plain codec's: on random streams, on every
    truncation of one, and with one byte flipped at every offset."""
    nat, py, jpy = codecs["native"], codecs["python"], JaxPyWalCodec()
    rng = random.Random(9)
    for _ in range(20):
        bodies = [rng.randbytes(rng.randint(0, 512))
                  for _ in range(rng.randint(0, 50))]
        blob = nat.frame(bodies)
        assert blob == py.frame(bodies) == jpy.frame(bodies)
        assert nat.scan(blob) == py.scan(blob) == (bodies, 0)
    length, crc = struct.unpack_from("<II", nat.frame([b"x" * 1000]), 0)
    assert (length, crc) == (1000, zlib.crc32(b"x" * 1000))
    blob = nat.frame([rng.randbytes(n) for n in (0, 3, 17, 64, 5, 200)])
    statuses = set()
    for cut in range(len(blob) + 1):
        got = nat.scan(blob[:cut])
        assert got == py.scan(blob[:cut]) == jpy.scan(blob[:cut]), cut
        statuses.add(got[1])
    for off in range(len(blob)):
        bad = bytearray(blob)
        bad[off] ^= 0x5A
        got = nat.scan(bytes(bad))
        assert got == py.scan(bytes(bad)) == jpy.scan(bytes(bad)), off
        statuses.add(got[1])
    assert statuses == {native.STATUS_OK, native.STATUS_TORN_TAIL,
                        native.STATUS_CORRUPT}


# ---- the host WAL in both packages ---------------------------------------

PKGS = {"jax": (jstorage, jmsg), "port": (tstorage, tmsg)}


def _entries(msg, lo, hi):
    return [msg.Entry(index=i, term=1, type=msg.EntryType.NORMAL,
                      data=b"payload-%d" % i) for i in range(lo, hi)]


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_wal_drops_torn_tail_on_bootstrap(pkg, tmp_path):
    storage, msg = PKGS[pkg]
    lg = storage.EncryptedRaftLogger(str(tmp_path))
    lg.bootstrap_new()
    lg.save(msg.HardState(term=1, vote=0, commit=0), _entries(msg, 1, 6))
    lg.close()
    (wal,) = glob.glob(os.path.join(str(tmp_path), "raft", "wal-*.log"))
    blob = open(wal, "rb").read()
    with open(wal, "wb") as f:
        f.write(blob[:-7])
    boot = storage.EncryptedRaftLogger(str(tmp_path)).bootstrap_from_disk()
    assert [e.index for e in boot.entries] == [1, 2, 3, 4]
    assert boot.hard_state is not None and boot.hard_state.term == 1


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_wal_refuses_midfile_corruption(pkg, tmp_path):
    storage, msg = PKGS[pkg]
    lg = storage.EncryptedRaftLogger(str(tmp_path))
    lg.bootstrap_new()
    lg.save(msg.HardState(term=1, vote=0, commit=0), _entries(msg, 1, 6))
    lg.close()
    (wal,) = glob.glob(os.path.join(str(tmp_path), "raft", "wal-*.log"))
    blob = bytearray(open(wal, "rb").read())
    blob[10] ^= 0xFF
    with open(wal, "wb") as f:
        f.write(bytes(blob))
    with pytest.raises(storage.DataCorrupt):
        storage.EncryptedRaftLogger(str(tmp_path)).bootstrap_from_disk()


def test_wal_round_trips_through_the_native_codec(tmp_path):
    lg = tstorage.EncryptedRaftLogger(str(tmp_path))
    lg.bootstrap_new()
    entries = [tmsg.Entry(index=i, term=1, type=tmsg.EntryType.NORMAL,
                          data=bytes([i]) * 64) for i in range(1, 51)]
    lg.save(tmsg.HardState(term=1, vote=1, commit=50), entries)
    lg.close()
    (wal,) = glob.glob(os.path.join(str(tmp_path), "raft", "wal-*.log"))
    bodies, status = native.wal_codec("python").scan(open(wal, "rb").read())
    assert status == native.STATUS_OK and len(bodies) == 51
    result = tstorage.EncryptedRaftLogger(str(tmp_path)).bootstrap_from_disk()
    assert [e.index for e in result.entries] == list(range(1, 51))
    assert result.hard_state.commit == 50


KEY1, KEY2 = bytes(range(32)), bytes(range(32, 64))


def _write_log(storage, msg, enc, path: str) -> None:
    """Entries 1-8 under KEY1, a snapshot at 5 (keeping 6-8), a DEK
    rotation to KEY2, then entries 9-12 and a conflicting rewrite of 12."""
    c1 = enc.SecretboxCrypter(KEY1)
    lg = storage.EncryptedRaftLogger(path, encrypter=c1, decrypter=c1)
    lg.bootstrap_new()
    lg.save(msg.HardState(term=1, vote=3, commit=4), _entries(msg, 1, 9))
    snap = msg.Snapshot(meta=msg.SnapshotMeta(index=5, term=1,
                                              voters=(3, 7, 11)),
                        data=b"snapshot payload")
    lg.save_snapshot(snap, retained_entries=_entries(msg, 1, 9),
                     hard_state=msg.HardState(term=1, vote=3, commit=5))
    lg.gc(5)
    c2 = enc.SecretboxCrypter(KEY2)
    lg.rotate_encryption_key(c2, c2)
    lg.save(msg.HardState(term=2, vote=7, commit=9), _entries(msg, 9, 13))
    lg.save(None, [msg.Entry(index=12, term=2, type=msg.EntryType.NORMAL,
                             data=b"rewritten")])
    lg.close()


def _read_log(storage, enc, path: str):
    dec = enc.MultiDecrypter(enc.SecretboxCrypter(KEY2),
                             enc.SecretboxCrypter(KEY1))
    lg = storage.EncryptedRaftLogger(path, encrypter=enc.SecretboxCrypter(
        KEY2), decrypter=dec)
    boot = lg.bootstrap_from_disk()
    lg.close()
    hs, snap = boot.hard_state, boot.snapshot
    return ((hs.term, hs.vote, hs.commit),
            [(e.index, e.term, int(e.type), e.data) for e in boot.entries],
            (snap.meta.index, snap.meta.term, tuple(snap.meta.voters),
             snap.data))


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_logger_state_dir_loads_in_the_other_package(writer, reader,
                                                     tmp_path):
    encs = {"jax": jenc, "port": tenc}
    (wstorage, wmsg), (rstorage, _) = PKGS[writer], PKGS[reader]
    _write_log(wstorage, wmsg, encs[writer], str(tmp_path))
    names = sorted(os.listdir(tmp_path / "raft"))
    assert names == ["snap-0000000000000005.bin", "wal-0000000000000005.log"]
    got = _read_log(rstorage, encs[reader], str(tmp_path))
    assert got == _read_log(wstorage, encs[writer], str(tmp_path))
    assert got == ((2, 7, 9), [(i, 1, 0, b"payload-%d" % i)
                               for i in range(6, 12)]
                   + [(12, 2, 0, b"rewritten")],
                   (5, 1, (3, 7, 11), b"snapshot payload"))


# ---- encryption: both branches --------------------------------------------

def _cross_check(j, t) -> dict:
    """Each package's records decrypt with the other's, for every
    algorithm; the envelopes encode alike.  Returns a record of each
    branch's algorithms, hex-encoded, for the other branch to try."""
    out = {}
    for name in ("SecretboxCrypter", "FernetCrypter"):
        jc, tc = getattr(j, name)(KEY1), getattr(t, name)(KEY1)
        for a, b in ((jc, tc), (tc, jc)):
            rec = a.encrypt(b"raft entry bytes")
            assert b.decrypt(rec) == b"raft entry bytes"
            raw = rec.encode()
            other = (j if b is jc else t).MaybeEncryptedRecord.decode(raw)
            assert other.encode() == raw
            assert b.decrypt(other) == b"raft entry bytes"
        out[name] = tc.encrypt(b"raft entry bytes").encode().hex()
    for pkg in (j, t):
        enc, dec = pkg.defaults(KEY1)
        assert dec.decrypt(enc.encrypt(b"x")) == b"x"
        enc, dec = pkg.defaults(None)
        assert dec.decrypt(enc.encrypt(b"x")) == b"x"
    with pytest.raises(t.encryption.DecryptError):
        t.SecretboxCrypter(KEY2).decrypt(
            j.SecretboxCrypter(KEY1).encrypt(b"x"))
    return out


_STAND_IN = r"""
import json, sys
sys.modules["cryptography"] = None
from swarmkit_tpu import encryption as j
from swarmkit_tpu.encryption import encryption as je
from swarmkit_tpu_torch import encryption as t
from swarmkit_tpu_torch.encryption import encryption as te
assert not je.HAVE_CRYPTOGRAPHY and not te.HAVE_CRYPTOGRAPHY
sys.path.insert(0, "tests")
from test_torch_raft_storage import _cross_check, KEY1
records = _cross_check(j, t)
foreign = json.loads(sys.argv[1])
for name, raw in foreign.items():
    rec = t.MaybeEncryptedRecord.decode(bytes.fromhex(raw))
    try:
        getattr(t, name)(KEY1).decrypt(rec)
    except t.encryption.DecryptError:
        pass
    else:
        raise AssertionError(f"{name}: a cryptography record decrypted")
print(json.dumps(records))
"""


def test_encryption_branches_cross_decrypt():
    assert tenc.encryption.HAVE_CRYPTOGRAPHY \
        == jenc.encryption.HAVE_CRYPTOGRAPHY
    here = _cross_check(jenc, tenc)
    res = subprocess.run([sys.executable, "-c", _STAND_IN, json.dumps(here)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    there = json.loads(res.stdout.strip().splitlines()[-1])
    if not tenc.encryption.HAVE_CRYPTOGRAPHY:
        return   # both runs took the stand-in branch
    for name, raw in there.items():
        rec = tenc.MaybeEncryptedRecord.decode(bytes.fromhex(raw))
        with pytest.raises(tenc.encryption.DecryptError):
            getattr(tenc, name)(KEY1).decrypt(rec)
