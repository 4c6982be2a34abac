"""Write-ahead delta journal + snapshots for ``ColoringSession`` (port of
``repro.dynamic.journal``: the same record format, CRC and snapshot files,
so a durable directory written by either package restores in the other).

A session that dies mid-churn used to lose its entire delta history — the
DeltaCSR overlay, the dirty frontier, and every committed recolor lived
only in process memory.  Durability here is the classic WAL pair:

* **journal.jsonl** — one CRC-guarded JSON record per mutation batch
  (``kind="delta"``, appended *before* the overlay mutates) and per
  committed recolor (``kind="recolor"``, appended after commit, so a crash
  between engine run and commit replays as "that recolor never happened" —
  exactly the state the dying process was in);
* **snapshot.npz / snapshot.json** — a full state checkpoint (DeltaCSR
  base + overlay keys, colors, dirty frontier, counters, engine options)
  written atomically (tmp + rename) by ``ColoringSession.checkpoint()``
  and automatically every ``snapshot_every`` journal records.

``ColoringSession.restore(dir)`` loads the latest snapshot and replays
every journal record after its sequence number through the normal
``apply_delta``/``recolor`` code paths — the engines are deterministic, so
the replayed state is **bit-identical** to the uninterrupted session
(tested in ``tests/test_torch_faultlab.py``).  A torn or corrupted journal tail
(the crash wrote half a record; ``repro_torch.faultlab.truncate_journal``
simulates it) fails its CRC and replay stops at the last good record — the
recovery report on the session says how far it got.
"""
from __future__ import annotations

import json
import os
import zlib

import numpy as np

__all__ = ["SessionJournal", "JOURNAL_NAME", "SNAPSHOT_META", "SNAPSHOT_DATA"]

JOURNAL_NAME = "journal.jsonl"
SNAPSHOT_META = "snapshot.json"
SNAPSHOT_DATA = "snapshot.npz"


def _record_crc(seq: int, kind: str, payload: dict) -> int:
    body = json.dumps({"seq": seq, "kind": kind, "payload": payload},
                      sort_keys=True, separators=(",", ":"))
    return zlib.crc32(body.encode())


class SessionJournal:
    """Append-only CRC'd JSONL journal + atomic snapshot pair in one dir."""

    def __init__(self, dirpath: str, *, fresh: bool = False):
        self.dir = str(dirpath)
        os.makedirs(self.dir, exist_ok=True)
        self.path = os.path.join(self.dir, JOURNAL_NAME)
        if fresh:
            for name in (JOURNAL_NAME, SNAPSHOT_META, SNAPSHOT_DATA):
                p = os.path.join(self.dir, name)
                if os.path.exists(p):
                    os.remove(p)
        self._seq = self._last_seq()

    # -- journal -----------------------------------------------------------
    def _last_seq(self) -> int:
        last = 0
        for rec in self.records():
            last = rec["seq"]
        return last

    @property
    def seq(self) -> int:
        """Sequence number of the last appended (or recovered) record."""
        return self._seq

    def append(self, kind: str, payload: dict) -> int:
        """Durably append one record; returns its sequence number."""
        self._seq += 1
        rec = {"seq": self._seq, "kind": kind, "payload": payload,
               "crc": _record_crc(self._seq, kind, payload)}
        line = json.dumps(rec, sort_keys=True, separators=(",", ":"))
        with open(self.path, "a") as f:
            f.write(line + "\n")
            f.flush()
            os.fsync(f.fileno())
        return self._seq

    def records(self, after_seq: int = 0):
        """Yield valid records with ``seq > after_seq``; stop at corruption.

        A record that fails to parse, fails its CRC, or breaks the
        monotone sequence marks the torn tail of a crashed write — it and
        everything after it are ignored (``self.truncated`` reports it).
        """
        self.truncated = False
        if not os.path.exists(self.path):
            return
        expect = None
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                    ok = (rec.get("crc") == _record_crc(
                        rec["seq"], rec["kind"], rec["payload"]))
                except (ValueError, KeyError, TypeError):
                    ok = False
                if not ok or (expect is not None and rec["seq"] != expect):
                    self.truncated = True
                    return
                expect = rec["seq"] + 1
                if rec["seq"] > after_seq:
                    yield rec

    # -- snapshots -----------------------------------------------------------
    def write_snapshot(self, arrays: dict, meta: dict) -> None:
        """Atomically persist a full-state checkpoint at the current seq."""
        meta = dict(meta, seq=self._seq)
        tmp_npz = os.path.join(self.dir, SNAPSHOT_DATA + ".tmp")
        with open(tmp_npz, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp_npz, os.path.join(self.dir, SNAPSHOT_DATA))
        tmp_meta = os.path.join(self.dir, SNAPSHOT_META + ".tmp")
        with open(tmp_meta, "w") as f:
            json.dump(meta, f, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp_meta, os.path.join(self.dir, SNAPSHOT_META))

    def load_snapshot(self) -> tuple[dict, dict] | None:
        """The latest checkpoint as ``(arrays, meta)``, or None."""
        meta_path = os.path.join(self.dir, SNAPSHOT_META)
        data_path = os.path.join(self.dir, SNAPSHOT_DATA)
        if not (os.path.exists(meta_path) and os.path.exists(data_path)):
            return None
        with open(meta_path) as f:
            meta = json.load(f)
        with np.load(data_path) as z:
            arrays = {k: z[k] for k in z.files}
        return arrays, meta
