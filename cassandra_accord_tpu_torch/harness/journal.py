"""Simulated persistence: per-command field-diff log + reconstruction.

Capability parity with ``accord.impl.basic.Journal`` (Journal.java:59-542,174,310):
every command state transition appends a field-level diff; ``reconstruct`` replays
the diffs into fresh state, and the burn harness asserts the reconstruction matches
the live store — proving the recorded (serializable) state is sufficient for
persistence/replay, the checkpoint/resume contract of SURVEY §5.

Fields are serialized through the maelstrom wire codec, so the journal also
continuously exercises full-state serializability.

Gray-failure extensions (round 7):

- every record is stored as its canonical JSON **bytes + CRC32** — the replay
  path re-verifies each record, so torn writes and bit rot are DETECTED, never
  silently replayed;
- ``stall``/``unstall``/``lose_unsynced`` model a stalled append path
  (durability lags execution): a crash mid-stall loses the whole unsynced
  tail, strictly more than ``drop_tail`` experiments ever did;
- ``corrupt_random_record``/``tear_tail_record`` inject crash-time damage, and
  ``restart_replay`` applies the corrupt-record policy: a damaged TAIL record
  truncates to the last whole record (normal WAL semantics); a damaged
  MID-LOG record either raises ``JournalCorruption`` (halt-loud) or
  quarantines the txn — records dropped, footprint reported so the restart
  re-enters the bootstrap catch-up ladder over it.
"""
from __future__ import annotations

import json
import zlib
from typing import Callable, Dict, List, Optional, Tuple

from ..local.command import Command, WaitingOn
from ..local.status import Durability, SaveStatus
from ..maelstrom import codec
from ..primitives.timestamp import TxnId

_FIELDS = ("save_status", "durability", "route", "partial_txn", "partial_deps",
           "promised", "accepted_or_committed", "execute_at", "writes", "result",
           "applied_locally", "elided_unapplied")
# NOTE: elided_unapplied rides the identity-diff (`is`) skip like every other
# field, so it is ASSIGN-ONLY on Command — mutating the set in place would
# silently skip re-encoding (local/commands.py _note_elided_unless_applied
# and the serve-time prune both reassign fresh sets)
_MISSING = object()


def _encode_fields(command: Command) -> Dict[str, object]:
    return {f: codec.encode_value(getattr(command, f)) for f in _FIELDS}


class JournalCorruption(Exception):
    """A journal record failed checksum/parse verification at replay and the
    corrupt-record policy is halt-loud."""


class Record:
    """One durable journal append: the field-diff's canonical JSON bytes plus
    the CRC32 computed at append time.  Damage injection mutates ``payload``
    only — the stored checksum then witnesses the corruption at replay
    (CRC32 catches every single-bit flip and, practically, every torn
    truncation)."""

    __slots__ = ("payload", "crc")

    def __init__(self, payload: bytes, crc: int):
        self.payload = payload
        self.crc = crc

    @classmethod
    def encode(cls, diff: Dict[str, object]) -> "Record":
        payload = json.dumps(diff, sort_keys=True,
                             separators=(",", ":")).encode()
        return cls(payload, zlib.crc32(payload))

    def try_diff(self) -> Optional[Dict[str, object]]:
        """The decoded field-diff, or None if the record is damaged."""
        if zlib.crc32(self.payload) != self.crc:
            return None
        try:
            return json.loads(self.payload.decode())
        except (UnicodeDecodeError, ValueError):
            return None

    def diff(self) -> Dict[str, object]:
        d = self.try_diff()
        if d is None:
            raise JournalCorruption("record failed checksum/parse verification")
        return d


class RestartReplay:
    """Result of a verified restart replay over one (node, store) log."""

    __slots__ = ("commands", "quarantined", "torn_tail_dropped",
                 "corrupt_records")

    def __init__(self, commands: Dict[TxnId, Command],
                 quarantined: Dict[TxnId, object],
                 torn_tail_dropped: int, corrupt_records: int):
        self.commands = commands
        # txn -> last-known Route (None when no intact record named one):
        # the caller scopes the bootstrap quarantine from these
        self.quarantined = quarantined
        self.torn_tail_dropped = torn_tail_dropped
        self.corrupt_records = corrupt_records


class Journal:
    """One journal per cluster; keyed by (node_id, store_id)."""

    def __init__(self):
        # (node, store) -> txn_id -> list of diffs (field -> encoded value)
        self.logs: Dict[Tuple[int, int], Dict[TxnId, List[Dict[str, object]]]] = {}
        # last full encoded state per txn (for diffing)
        self._last: Dict[Tuple[int, int, TxnId], Dict[str, object]] = {}
        # decoded-route memo for peek_route (invalidated on save/erase)
        self._routes: Dict[Tuple[int, int, TxnId], object] = {}
        # last raw field objects per txn: a field whose object is IDENTICAL
        # (is) to the last-saved one cannot have changed (command fields are
        # assigned, never mutated in place) and skips re-encoding — without
        # this every transition re-encodes the full deps payload just to
        # discover it is unchanged (dominant cost in hostile burns);
        # verify_against still proves the recorded state sufficient
        self._raw: Dict[Tuple[int, int, TxnId], Dict[str, object]] = {}
        # global append order per (node, store): the write-ahead sequence a
        # drop_tail (unsynced-tail loss) truncation operates on
        self._order: Dict[Tuple[int, int], List[TxnId]] = {}
        # erased-entry count per (node, store): erase() leaves stale TxnIds in
        # _order; once they outnumber the live ones the list is compacted, so
        # a long GC-heavy burn doesn't pin one dead reference per save forever
        self._order_dead: Dict[Tuple[int, int], int] = {}
        # node -> per-(node,store) live-record-count snapshot at stall time:
        # the durable watermark a mid-stall crash rewinds to
        self._stalled: Dict[int, Dict[Tuple[int, int], int]] = {}
        # sim-time supplier (installed by the owning Cluster) + last-append
        # times: the torn-write injector must only tear records no peer can
        # have acked yet (see tear_tail_record)
        self.now_us: Optional[Callable[[], int]] = None
        self._append_us: Dict[Tuple[int, int], int] = {}
        self.records = 0

    def attach(self, store) -> None:
        """Install this journal as the store's on-save hook."""
        store.journal = self

    # -- recording -----------------------------------------------------------
    def save(self, store, command: Command) -> None:
        key3 = (store.node.id, store.id, command.txn_id)
        prev = self._last.get(key3)
        if prev is None:
            diff = _encode_fields(command)
            self._last[key3] = dict(diff)
            self._raw[key3] = {f: getattr(command, f) for f in _FIELDS}
        else:
            raw = self._raw.setdefault(key3, {})
            diff = {}
            for f in _FIELDS:
                v = getattr(command, f)
                if raw.get(f, _MISSING) is v:
                    continue
                raw[f] = v
                enc = codec.encode_value(v)
                if prev.get(f) != enc:
                    prev[f] = enc
                    diff[f] = enc
            if not diff:
                return
        if "route" in diff:
            self._routes.pop(key3, None)
        self.logs.setdefault(key3[:2], {}).setdefault(command.txn_id, []) \
            .append(Record.encode(diff))
        self._order.setdefault(key3[:2], []).append(command.txn_id)
        if self.now_us is not None:
            self._append_us[key3[:2]] = self.now_us()
        self.records += 1

    def erase(self, store, txn_id: TxnId) -> None:
        """GC erasure also erases the journal entry (tombstone drop)."""
        self.erase_key(store.node.id, store.id, txn_id)

    def erase_key(self, node_id: int, store_id: int, txn_id: TxnId) -> None:
        """Store-object-free erase (restart-time quarantine runs before the
        rebuilt store exists)."""
        key = (node_id, store_id)
        logs = self.logs.get(key, {})
        recs = logs.pop(txn_id, None)
        self._last.pop(key + (txn_id,), None)
        self._routes.pop(key + (txn_id,), None)
        self._raw.pop(key + (txn_id,), None)
        if recs:
            dead = self._order_dead.get(key, 0) + len(recs)
            order = self._order.get(key)
            if order is not None and dead * 2 > len(order):
                order[:] = [t for t in order if t in logs]
                dead = 0
            self._order_dead[key] = dead

    def on_evict(self, store, txn_id: TxnId) -> None:
        """The store evicted this command: drop the raw-identity memo so the
        journal does not pin the full field object graph of cold state (the
        encoded _last stays — it IS the fault-in source).  The next save after
        a fault-in re-encodes each field once and repopulates the memo."""
        self._raw.pop((store.node.id, store.id, txn_id), None)

    def peek_route(self, store, txn_id: TxnId):
        """Decode ONLY the journaled route of an evicted command — scans that
        merely need a footprint filter (recovery evidence) must not pay a full
        command decode per cold entry (the hostile churn matrix spent most of
        its wall-clock in exactly that)."""
        return self._peek_route((store.node.id, store.id, txn_id))

    def _peek_route(self, key3):
        route = self._routes.get(key3)
        if route is None:
            full = self._last.get(key3)
            if full is None:
                return None
            enc = full.get("route")
            if enc is None:
                return None
            route = codec.decode_value(enc)
            self._routes[key3] = route
        return route

    # -- reconstruction (Journal.reconstruct) --------------------------------
    def reconstruct(self, node_id: int, store_id: int) -> Dict[TxnId, Command]:
        out: Dict[TxnId, Command] = {}
        for txn_id, recs in self.logs.get((node_id, store_id), {}).items():
            command = Command(txn_id)
            for rec in recs:
                for field, encoded in rec.diff().items():
                    setattr(command, field, codec.decode_value(encoded))
            out[txn_id] = command
        return out

    def reconstruct_one(self, store, txn_id: TxnId) -> Optional[Command]:
        """Rebuild ONE command from its latest recorded state — the
        cache-miss reload path (SafeCommandStore._fault_in)."""
        full = self._last.get((store.node.id, store.id, txn_id))
        if full is None:
            return None
        command = Command(txn_id)
        for field, encoded in full.items():
            setattr(command, field, codec.decode_value(encoded))
        return command

    # -- restart (crash-restart nemesis) --------------------------------------
    def restart_commands(self, node_id: int, store_id: int) -> Dict[TxnId, Command]:
        """Reconstruct a crashed store's commands for restart: everything the
        journal recorded, with legitimately-volatile state collapsed to its
        durable tier (READY_TO_EXECUTE resumes from STABLE, APPLYING from
        PRE_APPLIED — the round-3 replay contract).  waiting_on / listeners
        are never journaled: the restart path re-derives them.  Halt-loud on
        any damaged record; ``restart_replay`` is the policy-aware variant."""
        return self.restart_replay(node_id, store_id, policy="halt").commands

    def restart_replay(self, node_id: int, store_id: int,
                       policy: str = "quarantine") -> RestartReplay:
        """Verified restart reconstruction: every record is re-checked against
        its append-time CRC32.

        - A damaged record at the very TAIL of the log is a torn write (the
          crash interrupted the append): silently truncate to the last whole
          record, exactly like any write-ahead log.
        - A damaged MID-LOG record is corruption (bit rot, firmware lies):
          ``policy="halt"`` raises JournalCorruption; ``policy="quarantine"``
          drops every record of the affected txn and reports its last-known
          route so the caller can bootstrap-catch-up the footprint."""
        assert policy in ("halt", "quarantine"), policy
        key = (node_id, store_id)
        logs = self.logs.get(key, {})
        # 1. torn tail: truncate trailing damaged records (append order)
        torn = 0
        while True:
            tail_txn = self._tail_txn(key)
            if tail_txn is None:
                break
            recs = logs.get(tail_txn)
            if recs and recs[-1].try_diff() is None:
                self._drop_last_record(key)
                torn += 1
            else:
                break
        # 2. decode everything else; any remaining damage is mid-log corruption
        commands: Dict[TxnId, Command] = {}
        quarantined: Dict[TxnId, object] = {}
        corrupt = 0
        for txn_id in list(logs):
            diffs = []
            for rec in logs[txn_id]:
                d = rec.try_diff()
                if d is None:
                    diffs = None
                    break
                diffs.append(d)
            if diffs is None:
                corrupt += 1
                if policy == "halt":
                    raise JournalCorruption(
                        f"corrupt journal record for {txn_id} on node "
                        f"{node_id}/store {store_id} (policy=halt)")
                route = self._peek_route(key + (txn_id,))
                self.erase_key(node_id, store_id, txn_id)
                quarantined[txn_id] = route
                continue
            command = Command(txn_id)
            for diff in diffs:
                for field, encoded in diff.items():
                    setattr(command, field, codec.decode_value(encoded))
            command.save_status = self._durable_status(command.save_status)
            commands[txn_id] = command
        return RestartReplay(commands, quarantined, torn, corrupt)

    def drop_tail(self, node_id: int, store_id: int, count: int) -> int:
        """Drop the last ``count`` records of a store's log — simulated loss
        of an unsynced write-ahead tail at crash.  Returns records dropped.
        NOTE: losing promise/accept records is NOT sound for consensus (a
        real journal fsyncs before replying); this exists for targeted
        durability experiments.  The disk-stall nemesis gets the same effect
        soundly by ALSO holding the node's outbound replies for the stall
        (fsync-before-reply: no peer ever observes state that was lost)."""
        key = (node_id, store_id)
        dropped = 0
        while dropped < count and self._drop_last_record(key) is not None:
            dropped += 1
        return dropped

    def _tail_txn(self, key: Tuple[int, int]) -> Optional[TxnId]:
        """The txn owning the globally-LAST live record of a store's log."""
        order = self._order.get(key, [])
        logs = self.logs.get(key, {})
        for txn_id in reversed(order):
            if logs.get(txn_id):
                return txn_id
        return None

    def _drop_last_record(self, key: Tuple[int, int]) -> Optional[TxnId]:
        """Remove the newest record of a store's log, rewinding the
        latest-state snapshot to the surviving prefix.  Returns the owning
        txn, or None if the log is empty."""
        order = self._order.get(key, [])
        logs = self.logs.get(key, {})
        while order:
            txn_id = order.pop()
            recs = logs.get(txn_id)
            if not recs:
                # erased since; its order entries are stale — keep the dead
                # count exact or _live_count over-reports after a drop
                dead = self._order_dead.get(key, 0)
                if dead:
                    self._order_dead[key] = dead - 1
                continue
            recs.pop()
            key3 = key + (txn_id,)
            self._raw.pop(key3, None)
            self._routes.pop(key3, None)
            if not recs:
                del logs[txn_id]
                self._last.pop(key3, None)
            else:
                # rebuild the latest-state snapshot from the surviving records
                full: Dict[str, object] = {}
                for rec in recs:
                    d = rec.try_diff()
                    if d is not None:
                        full.update(d)
                self._last[key3] = full
            self.records -= 1
            return txn_id
        return None

    # -- journal-append stalls (disk-stall nemesis) ---------------------------
    def _live_count(self, key: Tuple[int, int]) -> int:
        return len(self._order.get(key, ())) - self._order_dead.get(key, 0)

    def stall(self, node_id: int) -> None:
        """Freeze the durable watermark: appends keep landing in memory but
        nothing past this point is fsynced until ``unstall``.  A crash while
        stalled (``lose_unsynced``) rewinds to the watermark."""
        if node_id in self._stalled:
            return
        snap = {key: self._live_count(key)
                for key in self._order if key[0] == node_id}
        self._stalled[node_id] = snap

    def unstall(self, node_id: int) -> None:
        """The append path caught up: everything buffered is now durable."""
        self._stalled.pop(node_id, None)

    def is_stalled(self, node_id: int) -> bool:
        return node_id in self._stalled

    def lose_unsynced(self, node_id: int) -> int:
        """Crash during a stall: every record appended after the stall began
        is gone.  Returns records lost.  (Erase interleavings make the
        positional rewind conservative: an erased pre-stall txn shrinks the
        live count, so at most FEWER post-stall records are dropped.)"""
        snap = self._stalled.pop(node_id, None)
        if snap is None:
            return 0
        lost = 0
        for key in list(self._order):
            if key[0] != node_id:
                continue
            excess = self._live_count(key) - snap.get(key, 0)
            if excess > 0:
                lost += self.drop_tail(key[0], key[1], excess)
        return lost

    # -- damage injection (the hostile matrix's corruption axis) --------------
    def corrupt_random_record(self, node_id: int, rng) -> Optional[Tuple]:
        """Flip one random bit in one random NON-TAIL record of ``node_id``'s
        logs (bit rot / firmware lies).  The stored CRC32 witnesses it at
        replay.  The global tail record is excluded: replay classifies a
        damaged tail as a torn write and silently truncates it — but this
        record may be long-acked, and rolling an acked promise/accept back is
        injection unsoundness, not a protocol bug (the torn-write injector
        has its own cannot-have-been-acked age gate).  Returns
        (key, txn_id, record_index) or None if the node has no eligible
        records."""
        entries = []
        for key, logs in self.logs.items():
            if key[0] != node_id:
                continue
            tail = self._tail_txn(key)
            for txn_id, recs in logs.items():
                last = len(recs) - (1 if txn_id == tail else 0)
                for i in range(last):
                    entries.append((key, txn_id, i))
        if not entries:
            return None
        key, txn_id, i = rng.pick(entries)
        rec = self.logs[key][txn_id][i]
        payload = bytearray(rec.payload)
        bit = rng.next_int(len(payload) * 8)
        payload[bit // 8] ^= 1 << (bit % 8)
        rec.payload = bytes(payload)
        return (key, txn_id, i)

    def tear_tail_record(self, node_id: int, rng,
                         max_age_us: Optional[int] = None) -> int:
        """Truncate the LAST record of each of ``node_id``'s store logs to a
        strict prefix — the partial append a crash tears.  Returns records
        torn; restart replay truncates them to the last whole record.

        ``max_age_us`` gates soundness: a record appended more than one
        minimum link latency before the crash may already have been ACKED to
        a peer (fsync-before-reply: synced, then replied), and tearing it
        would roll back a promise the protocol assumes stable.  With the
        gate, only appends the crash provably raced — no reply can have
        crossed the wire yet — are torn; older tails are left intact (the
        crash simply didn't interrupt a write)."""
        torn = 0
        now = self.now_us() if self.now_us is not None else None
        for key in list(self._order):
            if key[0] != node_id:
                continue
            if max_age_us is not None and now is not None \
                    and now - self._append_us.get(key, 0) > max_age_us:
                continue
            tail = self._tail_txn(key)
            if tail is None:
                continue
            rec = self.logs[key][tail][-1]
            if len(rec.payload) < 2:
                continue
            cut = 1 + rng.next_int(len(rec.payload) - 1)
            rec.payload = rec.payload[:cut]
            torn += 1
        return torn

    # -- verification ---------------------------------------------------------
    @staticmethod
    def _durable_status(status: SaveStatus) -> SaveStatus:
        """Collapse transient LocalExecution sub-states to their durable tier
        (SaveStatus.java LocalExecution): READY_TO_EXECUTE and APPLYING are
        volatile — a restart legitimately resumes from STABLE / PRE_APPLIED."""
        if status is SaveStatus.READY_TO_EXECUTE:
            return SaveStatus.STABLE
        if status is SaveStatus.APPLYING:
            return SaveStatus.PRE_APPLIED
        return status

    def verify_against(self, store) -> None:
        """Reconstruction must match the live store's command state for every
        durable field (waiting_on/listeners are transient execution state)."""
        rebuilt = self.reconstruct(store.node.id, store.id)
        live = store.commands
        for txn_id, command in live.items():
            if command.save_status is SaveStatus.NOT_DEFINED:
                continue  # never reached a durable state
            copy = rebuilt.get(txn_id)
            assert copy is not None, \
                f"journal lost {txn_id} on node {store.node.id}/store {store.id}"
            a = self._durable_status(command.save_status)
            b = self._durable_status(copy.save_status)
            assert a is b, \
                f"journal mismatch {txn_id}.save_status: live={a!r} rebuilt={b!r}"
            for f in ("durability", "execute_at"):
                va, vb = getattr(command, f), getattr(copy, f)
                assert va == vb or (va is vb), \
                    f"journal mismatch {txn_id}.{f}: live={va!r} rebuilt={vb!r}"
            assert (command.writes is None) == (copy.writes is None), \
                f"journal writes mismatch for {txn_id}"
        cold = getattr(store, "cold", set())
        for txn_id in rebuilt:
            assert txn_id in live or txn_id in cold, \
                f"journal has {txn_id} the live store erased without journal.erase"


