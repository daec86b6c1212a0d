"""Online protocol-invariant auditor: first-divergence detection over the
flight-recorder stream.

``InvariantAuditor`` IS a ``FlightRecorder`` (same hook surface, same
registry/spans/trace planes) that additionally checks, per event, the rule
catalog in ``observe/rules.py``:

1. **SaveStatus edge legality** per (node, store, txn): every observed
   transition must be a ``LEGAL_EDGES`` edge.  Crash/restart re-baselines a
   node's per-store lifecycle state (journal replay legitimately re-observes
   commands at their durable tier, which can sit below the volatile
   pre-crash status).
2. **Commit agreement**: the first decided (``PRE_COMMITTED``-or-later)
   observation of a txn fixes its executeAt cluster-wide — every later
   decided observation on any replica must match, and a decided executeAt
   may never mutate.  The first time two replicas both reach a deps-carrying
   commit tier (COMMITTED / STABLE, compared per tier), their deps restricted
   to the ranges both stores own must be identical; a store's stable deps
   must not mutate while the txn executes.  A decided txn observed
   INVALIDATED anywhere — the exact shape of the PR-2 quarantine-evidence
   bug — violates ``commit.invalidate_conflict``.  Two distinct txns
   deciding the same executeAt violate uniqueness (the hlc+node tiebreak
   contract ``_still_blocks`` relies on).
3. **Per-key / per-txn order**: ballots (``promised`` and
   ``accepted_or_committed``) are monotone per txn per store; normal-path
   applies (the APPLYING -> APPLIED edge) of key-domain writes land in
   strictly increasing executeAt order per key per store (merge paths —
   adoption, replay, heal — are exempt by construction: they never take that
   edge).
4. **Durability / epoch monotonicity**: a store's durability and redundancy
   watermarks never regress (checked lazily on ``durable_gen`` advances);
   a node's topology epoch never regresses within an incarnation; the
   cluster epoch-sync ledger only grows.
5. **Liveness SLO** (flags, never raises): an undecided client txn past
   ``slo_unattended_s`` with no recovery/invalidation attempt attributed, or
   past ``slo_undecided_s`` at all, or decided more than ``slo_unapplied_s``
   ago without any replica reaching APPLIED, opens a flag; the flag closes
   when the condition clears.  ``harness/watchdog.py`` embeds the open flags
   in every stall dump.

On a safety violation the auditor raises ``AuditViolation`` (``strict``) or
records it (``warn``); either way the violation carries the offending txn's
full flight-recorder timeline and a registry snapshot, so a nemesis-found
bug arrives pre-localized to its first bad event.

Zero observer effect: every check reads values the instrumented code already
computed (command fields, store watermarks, sim timestamps) — no RNG, no
wall clock, no scheduling.  ``tests/test_audit.py`` proves it the same way
PR 3 proved the recorder: same-seed hostile burn, ``--audit=strict`` vs off,
byte-identical message traces.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..local.status import Durability, SaveStatus
from ..primitives.timestamp import Domain
from . import rules
from .flight import FlightRecorder


class AuditViolation(Exception):
    """A protocol invariant broke; carries the first bad event's full context.

    ``report()`` renders the plain-data record the burn CLI embeds in
    ``--json`` and the watchdog embeds in stall dumps; ``timeline`` is the
    offending txn's complete flight-recorder span (every per-node/per-store
    SaveStatus transition with sim timestamps) and ``registry`` a metrics
    snapshot taken at the violating event."""

    def __init__(self, rule: str, detail: str, txn_id=None,
                 node: Optional[int] = None, store: Optional[int] = None,
                 now_us: Optional[int] = None, timeline: Optional[dict] = None,
                 registry: Optional[dict] = None,
                 causal_slice: Optional[dict] = None):
        where = " ".join(
            part for part in (
                f"txn {txn_id}" if txn_id is not None else None,
                f"at node {node}" if node is not None else None,
                f"store {store}" if store is not None else None,
                f"sim {now_us}us" if now_us is not None else None)
            if part is not None)
        super().__init__(f"[{rule}] {detail}" + (f" ({where})" if where else ""))
        self.rule = rule
        self.detail = detail
        self.txn_id = txn_id
        self.node = node
        self.store = store
        self.now_us = now_us
        self.timeline = timeline
        self.registry = registry
        # bounded k-hop backward causal slice of the bad event (the ancestor
        # cone from observe/provenance.py), when a recorder was attached
        self.causal_slice = causal_slice

    def report(self, include_registry: bool = False) -> dict:
        out = {
            "rule": self.rule,
            "detail": self.detail,
            "txn_id": None if self.txn_id is None else str(self.txn_id),
            "node": self.node,
            "store": self.store,
            "sim_us": self.now_us,
            "timeline": self.timeline,
        }
        if self.causal_slice is not None:
            out["causal_slice"] = self.causal_slice
        if include_registry:
            out["registry"] = self.registry
        return out


class _TxnAudit:
    """Cross-replica agreement state for one transaction."""

    __slots__ = ("execute_at", "decided_at", "commits", "stables",
                 "invalidated_at", "decided_us", "applied", "attempts")

    def __init__(self):
        self.execute_at = None        # first decided executeAt (+ witness)
        self.decided_at = None        # (node, store) that fixed it
        # per commit tier: {(node, store): (ranges, deps)} — first per store
        self.commits: Dict[Tuple[int, int], Tuple[object, object]] = {}
        self.stables: Dict[Tuple[int, int], Tuple[object, object]] = {}
        self.invalidated_at = None    # (node, store) that invalidated
        self.decided_us = None        # sim time of the first decided event
        self.applied = False          # any replica reached APPLIED
        self.attempts = 0             # recovery/invalidation attempts


class InvariantAuditor(FlightRecorder):
    """A FlightRecorder that halts at the first violated protocol invariant.

    ``mode``: ``"strict"`` raises AuditViolation at the violating event
    (recording it first); ``"warn"`` records only.  SLO flags are always
    recorded, never raised (liveness lag is provisional by nature — a late
    recovery can still settle the txn)."""

    def __init__(self, mode: str = "strict",
                 slo_unattended_s: Optional[float] = None,
                 slo_undecided_s: Optional[float] = None,
                 slo_unapplied_s: Optional[float] = None,
                 message_ring: Optional[int] = None,
                 record_messages: bool = False,
                 timeline=None, burnrate=None, provenance=None):
        assert mode in ("strict", "warn"), f"bad audit mode {mode!r}"
        super().__init__(message_ring=message_ring,
                         record_messages=record_messages,
                         timeline=timeline, burnrate=burnrate,
                         provenance=provenance)
        self.mode = mode
        # single source for the SLO ladder: call sites pass the user value
        # through (None = default), and the decision/apply budgets default to
        # one ladder step above the unattended budget
        if slo_unattended_s is None:
            slo_unattended_s = 10.0
        if slo_undecided_s is None:
            slo_undecided_s = max(6 * slo_unattended_s, 60.0)
        if slo_unapplied_s is None:
            slo_unapplied_s = max(6 * slo_unattended_s, 60.0)
        self.slo_unattended_us = int(slo_unattended_s * 1_000_000)
        self.slo_undecided_us = int(slo_undecided_s * 1_000_000)
        self.slo_unapplied_us = int(slo_unapplied_s * 1_000_000)
        self.cluster = None           # attached by Cluster.__init__ (weakly
                                      # duck-typed: anything with .nodes works)
        self.violations: List[AuditViolation] = []
        self.events_audited = 0
        # (node, store) -> txn -> last status name; re-baselined at crash
        self._last_status: Dict[Tuple[int, int], Dict[object, str]] = {}
        # (node, store) -> txn -> (promised, accepted_or_committed)
        self._ballots: Dict[Tuple[int, int], Dict[object, tuple]] = {}
        # (node, store) -> routing key -> (executeAt, txn) normal-apply watermark
        self._key_applied: Dict[Tuple[int, int], Dict[object, tuple]] = {}
        # (node, store) -> last seen tfk_inversions counter (legal-inversion
        # classification handshake with the per-key execution registers)
        self._tfk_seen: Dict[Tuple[int, int], int] = {}
        # (node, store) -> (durable_gen, majority, universal, shard, local)
        self._watermarks: Dict[Tuple[int, int], tuple] = {}
        # node -> last seen topology epoch (per incarnation)
        self._epochs: Dict[int, int] = {}
        # epoch -> last seen sync-ledger completion count
        self._ledger: Dict[int, int] = {}
        self._txns: Dict[object, _TxnAudit] = {}
        # executeAt -> txn (decided-timestamp uniqueness)
        self._decided_ts: Dict[object, object] = {}
        # nodes between crash and restart-complete: replay re-baselines
        self._replaying: set = set()
        # liveness SLO plane
        self._open_client: Dict[object, dict] = {}   # txn -> client record
        self._slo_flags: Dict[Tuple[str, object], dict] = {}
        self._slo_history: List[dict] = []
        self._next_slo_check_us = None

    # -- lifecycle (cluster crash/restart notifications) ---------------------
    def attach_cluster(self, cluster) -> None:
        self.cluster = cluster

    def on_crash(self, node_id: int) -> None:
        super().on_crash(node_id)
        self._replaying.add(node_id)
        # the process died: volatile lifecycle/ballot state is gone and the
        # journal replay re-observes commands at their durable tier — drop
        # every per-store baseline for the node
        for key in [k for k in self._last_status if k[0] == node_id]:
            self._last_status.pop(key, None)
            self._ballots.pop(key, None)
            self._key_applied.pop(key, None)
            self._watermarks.pop(key, None)
            self._tfk_seen.pop(key, None)
        self._epochs.pop(node_id, None)
        # the node's commit/stable deps records die with its volatile state:
        # a post-restart recovery may legally re-stabilize with a
        # different-but-sufficient cover, which must not be compared against
        # (or immutability-checked against) the pre-crash record
        for audit in self._txns.values():
            for records in (audit.commits, audit.stables):
                for key in [k for k in records if k[0] == node_id]:
                    records.pop(key, None)

    def on_restart(self, node_id: int) -> None:
        super().on_restart(node_id)
        self._replaying.discard(node_id)

    # -- violation plumbing --------------------------------------------------
    def _violate(self, rule: str, detail: str, txn_id=None, node=None,
                 store=None, now_us=None) -> None:
        timeline = None
        span = self.spans.spans.get(txn_id) if txn_id is not None else None
        if span is not None:
            timeline = span.to_dict()
        causal_slice = None
        if self.provenance is not None:
            # the bad event's bounded backward cone — walked NOW, while the
            # recorder still points at the transition that tripped the rule
            causal_slice = self.provenance.slice_for(
                txn_id=txn_id, node=node, store=store)
        violation = AuditViolation(rule, detail, txn_id=txn_id, node=node,
                                   store=store, now_us=now_us,
                                   timeline=timeline,
                                   registry=self.registry.snapshot(),
                                   causal_slice=causal_slice)
        self.violations.append(violation)
        self.registry.counter(f"audit.violation.{rule}").inc()
        if self.mode == "strict":
            raise violation

    # -- the audited hooks ---------------------------------------------------
    def on_submit(self, op_id: int, txn_id, coordinator: int,
                  now_us: int) -> None:
        super().on_submit(op_id, txn_id, coordinator, now_us)
        self._open_client[txn_id] = {"op_id": op_id, "submitted_us": now_us,
                                     "coordinator": coordinator}
        deadline = now_us + min(self.slo_unattended_us, self.slo_undecided_us)
        if self._next_slo_check_us is None or deadline < self._next_slo_check_us:
            self._next_slo_check_us = deadline

    def on_resolve(self, txn_id, kind: str, now_us: int) -> None:
        super().on_resolve(txn_id, kind, now_us)
        self._open_client.pop(txn_id, None)
        for flag_kind in rules.SLO_FLAGS:
            self._close_flag(flag_kind, txn_id, now_us, "resolved")
        self._slo_check(now_us)

    def on_recovery(self, node: int, txn_id, ballot=None, now_us=None) -> None:
        super().on_recovery(node, txn_id, ballot, now_us)
        audit = self._txns.get(txn_id)
        if audit is None:
            audit = self._txns[txn_id] = _TxnAudit()
        audit.attempts += 1
        if now_us is not None:
            self._close_flag(rules.SLO_UNATTENDED, txn_id, now_us,
                             "recovery attempt attributed")

    def on_invalidate(self, node: int, txn_id, now_us=None) -> None:
        super().on_invalidate(node, txn_id, now_us)
        audit = self._txns.get(txn_id)
        if audit is None:
            audit = self._txns[txn_id] = _TxnAudit()
        audit.attempts += 1
        if now_us is not None:
            self._close_flag(rules.SLO_UNATTENDED, txn_id, now_us,
                             "invalidation attempt attributed")

    def on_message_event(self, event: str, frm: int, to: int, msg_id,
                         message, now_us: int) -> None:
        super().on_message_event(event, frm, to, msg_id, message, now_us)
        self._slo_check(now_us)

    def on_reply_timeout(self, node: int, peer: int, txn_id,
                         now_us: int) -> None:
        super().on_reply_timeout(node, peer, txn_id, now_us)
        # a total wedge (all journals stalled: held sends, no message
        # events) still fires reply timeouts — without this pulse the SLO
        # scan would sleep through exactly the stalls it exists to flag
        self._slo_check(now_us)

    def on_transition(self, node: int, store: int, txn_id,
                      status_name: str, now_us: int,
                      command=None, command_store=None) -> None:
        super().on_transition(node, store, txn_id, status_name, now_us,
                              command=command, command_store=command_store)
        self.events_audited += 1
        key = (node, store)
        per_store = self._last_status.setdefault(key, {})
        prev = per_store.get(txn_id)
        if prev is None and node in self._replaying:
            # journal replay re-baselines: the first re-observation of each
            # txn is its durable tier, not an edge
            per_store[txn_id] = status_name
        else:
            frm = prev if prev is not None else "NOT_DEFINED"
            per_store[txn_id] = status_name
            if not rules.is_legal_edge(frm, status_name):
                self._violate(
                    rules.RULE_ILLEGAL_EDGE,
                    f"illegal SaveStatus transition {frm} -> {status_name}",
                    txn_id=txn_id, node=node, store=store, now_us=now_us)
        if command is not None:
            self._audit_ballots(key, txn_id, command, now_us)
            self._audit_agreement(node, store, txn_id, status_name, command,
                                  command_store, now_us)
            if prev == "APPLYING" and status_name == "APPLIED":
                self._audit_key_order(key, txn_id, command, command_store,
                                      now_us)
        if command_store is not None:
            self._audit_watermarks(key, command_store, now_us)
        self._audit_epochs(node, now_us)
        self._slo_check(now_us)

    # -- rule 2: commit agreement --------------------------------------------
    def _audit_agreement(self, node: int, store: int, txn_id, status_name: str,
                         command, command_store, now_us: int) -> None:
        status = SaveStatus[status_name]
        audit = self._txns.get(txn_id)
        if audit is None:
            audit = self._txns[txn_id] = _TxnAudit()
        if status is SaveStatus.INVALIDATED:
            audit.invalidated_at = (node, store)
            if audit.execute_at is not None:
                self._violate(
                    rules.RULE_COMMIT_INVALIDATE_CONFLICT,
                    f"txn invalidated at node {node}/store {store} but "
                    f"decided executeAt={audit.execute_at} was witnessed at "
                    f"node/store {audit.decided_at}",
                    txn_id=txn_id, node=node, store=store, now_us=now_us)
            return
        if status.is_truncated:
            return   # tombstones carry no (reliable) decision payload
        if status is SaveStatus.APPLIED:
            audit.applied = True
            self._close_flag(rules.SLO_UNAPPLIED, txn_id, now_us, "applied")
        if not status.is_decided or command.execute_at is None:
            return
        execute_at = command.execute_at
        # decided: executeAt fixed cluster-wide, forever
        if audit.execute_at is None:
            audit.execute_at = execute_at
            audit.decided_at = (node, store)
            audit.decided_us = now_us
            if txn_id in self._open_client:
                # (re-)arm the SLO scan for the unapplied deadline: the scan
                # may have gone dormant with every pre-decision deadline in
                # the past, and this is the only event that creates a new one
                deadline = now_us + self.slo_unapplied_us
                if self._next_slo_check_us is None \
                        or deadline < self._next_slo_check_us:
                    self._next_slo_check_us = deadline
            other = self._decided_ts.get(execute_at)
            if other is not None and other != txn_id:
                self._violate(
                    rules.RULE_EXECUTE_AT_DUPLICATE,
                    f"distinct txns {other} and {txn_id} both decided "
                    f"executeAt={execute_at}",
                    txn_id=txn_id, node=node, store=store, now_us=now_us)
            self._decided_ts[execute_at] = txn_id
            self._close_flag(rules.SLO_UNATTENDED, txn_id, now_us, "decided")
            self._close_flag(rules.SLO_UNDECIDED, txn_id, now_us, "decided")
        elif execute_at != audit.execute_at:
            rule = rules.RULE_EXECUTE_AT_MUTATED \
                if (node, store) == audit.decided_at \
                else rules.RULE_EXECUTE_AT_MISMATCH
            self._violate(
                rule,
                f"decided executeAt diverged: {audit.execute_at} (first at "
                f"node/store {audit.decided_at}) vs {execute_at} at "
                f"node {node}/store {store}",
                txn_id=txn_id, node=node, store=store, now_us=now_us)
        if audit.invalidated_at is not None:
            self._violate(
                rules.RULE_COMMIT_INVALIDATE_CONFLICT,
                f"txn decided at node {node}/store {store} but was "
                f"invalidated at node/store {audit.invalidated_at}",
                txn_id=txn_id, node=node, store=store, now_us=now_us)
        # cross-replica deps agreement at the COMMITTED tier only: that tier
        # is produced solely by the CommitSlowPath broadcast (one message,
        # one ballot, per-store slices of ONE deps set), where equality on
        # commonly-owned ranges is a true invariant.  The STABLE tier can
        # arrive via Propagate with coverage-gated partial merges and via
        # recovery re-stabilisation — different-but-sufficient covers — so
        # there the auditor checks LOCAL immutability instead.
        if status_name == "COMMITTED":
            self._audit_deps(audit.commits, "COMMITTED", node, store, txn_id,
                             command, command_store, now_us)
        elif status_name == "STABLE" and command.partial_deps is not None:
            audit.stables.setdefault(
                (node, store),
                (command.accepted_or_committed, None,
                 command.partial_deps, command_store))
        elif audit.stables and command.partial_deps is not None:
            # deps immutability while executing: the stable slice this store
            # recorded must still be what the command carries
            rec = audit.stables.get((node, store))
            if rec is not None:
                _ballot, _ranges, deps, _cs = rec
                now_ids = frozenset(command.partial_deps.txn_ids())
                then_ids = frozenset(deps.txn_ids())
                if now_ids != then_ids:
                    self._violate(
                        rules.RULE_DEPS_MUTATED,
                        f"stable deps mutated at node {node}/store {store}: "
                        f"{sorted(then_ids ^ now_ids)} changed",
                        txn_id=txn_id, node=node, store=store, now_us=now_us)

    def _audit_deps(self, records: dict, tier: str, node: int, store: int,
                    txn_id, command, command_store, now_us: int) -> None:
        """Cross-replica deps agreement at a commit tier, modulo ELISION:
        deps are a COVER, not a standalone consensus value — a recovery
        re-coordination at a higher ballot may legitimately compute a
        different (still sufficient) cover, and the data plane elides
        universally-durable and fenced entries.  What MUST agree is the same
        consensus round: two replicas committing at the SAME accepted ballot
        received the same broadcast, so their deps restricted to commonly-
        owned ranges must be identical modulo entries provably SETTLED
        (terminal, durable, or below a redundancy fence) at the store that
        lacks them.  A live differing dep within one ballot means the two
        replicas will execute in different orders — the divergence-class
        violation."""
        if command.partial_deps is None or command_store is None:
            return
        # the commit scope covers (at least) the store's ranges at the txn's
        # epoch — all_ranges() would over-claim ranges adopted LATER, whose
        # deps this commit's slice never carried
        ranges = command_store.ranges_at(txn_id.epoch)
        if not ranges:
            return
        ballot = command.accepted_or_committed
        mine = (ballot, ranges, command.partial_deps, command_store)
        for (other_node, other_store), (other_ballot, other_ranges,
                                        other_deps, other_cs) \
                in records.items():
            if (other_node, other_store) == (node, store):
                continue
            if other_ranges is None or other_ballot != ballot:
                continue   # different consensus rounds: covers may differ
            common = ranges.intersection(other_ranges)
            if not common:
                continue
            mine_sliced = command.partial_deps.slice(common)
            their_sliced = other_deps.slice(common)
            mine_ids = frozenset(mine_sliced.txn_ids())
            their_ids = frozenset(their_sliced.txn_ids())
            if mine_ids == their_ids:
                continue
            # they have it, we lack it: settled HERE?  we have it, they lack
            # it: settled THERE?
            unsettled = [
                dep for dep in their_ids - mine_ids
                if not self._dep_settled(command_store, dep,
                                         their_sliced.participants(dep))
            ] + [
                dep for dep in mine_ids - their_ids
                if not self._dep_settled(other_cs, dep,
                                         mine_sliced.participants(dep))
            ]
            if not unsettled:
                self.registry.counter("audit.deps_elision_diffs").inc()
                continue
            self._violate(
                rules.RULE_DEPS_MISMATCH,
                f"{tier} deps disagree on commonly-owned ranges "
                f"{common!r} with UNSETTLED differing deps "
                f"{sorted(unsettled)}: node {node}/store {store} vs the "
                f"first committer node/store {(other_node, other_store)} "
                f"(full diff: +{sorted(mine_ids - their_ids)} "
                f"-{sorted(their_ids - mine_ids)})",
                txn_id=txn_id, node=node, store=store, now_us=now_us)
        records.setdefault((node, store), mine)

    @staticmethod
    def _dep_settled(command_store, dep_id, participants) -> bool:
        """Is ``dep_id`` provably settled at ``command_store`` — terminal,
        durable at a majority, or below a local-redundancy fence — so that
        eliding it from a deps computation cannot change execution order?"""
        if command_store is None:
            return False
        cmd = command_store.commands.get(dep_id)
        if cmd is not None:
            if cmd.save_status in (SaveStatus.APPLIED, SaveStatus.INVALIDATED) \
                    or cmd.save_status.is_truncated:
                return True
            if cmd.durability >= Durability.MAJORITY:
                return True
        if dep_id in command_store.cold:
            return True   # eviction admits only terminal commands
        if participants is not None:
            keys, rngs = participants
            parts = list(keys) + list(rngs)
            if parts and command_store.redundant_before.is_locally_redundant(
                    dep_id, parts):
                return True
            if parts and command_store.durable_before.min_durability(
                    dep_id, parts) >= Durability.MAJORITY:
                return True
        return False

    # -- rule 3: per-txn ballot + per-key executeAt order ---------------------
    def _audit_ballots(self, key: Tuple[int, int], txn_id, command,
                       now_us: int) -> None:
        per_store = self._ballots.setdefault(key, {})
        prev = per_store.get(txn_id)
        cur = (command.promised, command.accepted_or_committed)
        per_store[txn_id] = cur
        if prev is None:
            return
        if cur[0] < prev[0] or cur[1] < prev[1]:
            which = "promised" if cur[0] < prev[0] else "accepted_or_committed"
            self._violate(
                rules.RULE_BALLOT_REGRESSION,
                f"{which} ballot regressed: {prev} -> {cur}",
                txn_id=txn_id, node=key[0], store=key[1], now_us=now_us)

    def _audit_key_order(self, key: Tuple[int, int], txn_id, command,
                         command_store, now_us: int) -> None:
        """Normal-path applies of key-domain writes must land in executeAt
        order per key per store (merge paths never take APPLYING->APPLIED)
        — UNLESS the inversion is one of the two classified-legal kinds:

        - the late txn is below the key's locally-redundant fence
          (bootstrap / catch-up landing: its deps were elided because the
          snapshot subsumes them, and the data store merges idempotently by
          executeAt — correct under MVCC);
        - the store's own per-key execution registers classified it
          (``tfk_inversions`` advances in ``update_last_execution`` BEFORE
          the APPLIED event fires — the heal/stale-recovery class the burn
          surfaces in its stats and escalates on growth).

        An out-of-order apply that neither a fence nor the tfk plane
        accounts for is a silent execution-frontier break — the violation."""
        if command_store is None:
            return
        counter = command_store.tfk_inversions
        seen = self._tfk_seen.get(key, 0)
        self._tfk_seen[key] = counter
        data_plane_classified = counter > seen
        if not txn_id.is_write or txn_id.domain is not Domain.KEY:
            return
        if command.writes is None or command.execute_at is None:
            return
        owned = command_store.all_ranges()
        watermark = self._key_applied.setdefault(key, {})
        for wkey in command.writes.keys:
            rk = wkey.to_routing() if hasattr(wkey, "to_routing") else wkey
            if not owned.contains(rk):
                continue   # unowned keys are not applied (or registered) here
            prev = watermark.get(rk)
            if prev is not None and command.execute_at <= prev[0]:
                fence = command_store.redundant_before \
                    .locally_redundant_before(rk)
                if fence is not None and txn_id < fence:
                    self.registry.counter("audit.key_inversions_fenced").inc()
                elif data_plane_classified:
                    self.registry.counter("audit.key_inversions_mvcc").inc()
                else:
                    self._violate(
                        rules.RULE_KEY_EXECUTE_AT_ORDER,
                        f"normal-path apply of key {rk!r} out of executeAt "
                        f"order: {command.execute_at} after {prev[0]} "
                        f"(txn {prev[1]}), with no local-redundancy fence "
                        f"above the late txn and no tfk-register "
                        f"classification",
                        txn_id=txn_id, node=key[0], store=key[1],
                        now_us=now_us)
            if prev is None or command.execute_at > prev[0]:
                watermark[rk] = (command.execute_at, txn_id)

    # -- rule 4: durability / epoch monotonicity ------------------------------
    def _audit_watermarks(self, key: Tuple[int, int], command_store,
                          now_us: int) -> None:
        gen = command_store.durable_gen
        prev = self._watermarks.get(key)
        if prev is not None and prev[0] == gen:
            return   # nothing advanced since the last sample
        footprint = command_store.all_ranges()
        majority, universal = \
            command_store.durable_before.max_bounds_over(footprint)
        shard = command_store.redundant_before.max_shard_redundant_over(
            footprint)
        local = command_store.redundant_before.max_locally_redundant_over(
            footprint)
        cur = (gen, majority, universal, shard, local)
        self._watermarks[key] = cur
        if prev is None:
            return
        for name, before, after in (("majority_durable", prev[1], majority),
                                    ("universal_durable", prev[2], universal),
                                    ("shard_redundant", prev[3], shard),
                                    ("locally_redundant", prev[4], local)):
            if before is not None and (after is None or after < before):
                self._violate(
                    rules.RULE_DURABILITY_REGRESSION,
                    f"{name} watermark regressed: {before} -> {after}",
                    node=key[0], store=key[1], now_us=now_us)

    def _audit_epochs(self, node: int, now_us: int) -> None:
        cluster = self.cluster
        if cluster is None:
            return
        node_obj = cluster.nodes.get(node)
        if node_obj is not None:
            epoch = node_obj.topology.current_epoch
            prev = self._epochs.get(node)
            if prev is not None and epoch < prev:
                self._violate(
                    rules.RULE_EPOCH_REGRESSION,
                    f"node topology epoch regressed: {prev} -> {epoch}",
                    node=node, now_us=now_us)
            self._epochs[node] = max(epoch, prev if prev is not None else epoch)
        ledger = getattr(cluster, "sync_ledger", None)
        if ledger:
            for epoch, completed in ledger.items():
                count = len(completed)
                prev_count = self._ledger.get(epoch, 0)
                if count < prev_count:
                    self._violate(
                        rules.RULE_SYNC_LEDGER_REGRESSION,
                        f"epoch {epoch} sync ledger shrank: "
                        f"{prev_count} -> {count}",
                        node=node, now_us=now_us)
                self._ledger[epoch] = max(count, prev_count)

    # -- rule 5: liveness SLO (flags, never raises) ---------------------------
    def _slo_check(self, now_us: int) -> None:
        if self._next_slo_check_us is None or now_us < self._next_slo_check_us:
            return
        next_deadline = None

        def consider(deadline):
            nonlocal next_deadline
            if next_deadline is None or deadline < next_deadline:
                next_deadline = deadline

        for txn_id, rec in list(self._open_client.items()):
            audit = self._txns.get(txn_id)
            attempts = audit.attempts if audit is not None else 0
            decided_us = audit.decided_us if audit is not None else None
            applied = audit.applied if audit is not None else False
            if decided_us is None:
                unattended_at = rec["submitted_us"] + self.slo_unattended_us
                if now_us >= unattended_at:
                    if attempts == 0:
                        self._open_flag(rules.SLO_UNATTENDED, txn_id, rec,
                                        now_us,
                                        f"undecided for "
                                        f"{(now_us - rec['submitted_us']) / 1e6:.1f}"
                                        f"s with no recovery/invalidation "
                                        f"attempt attributed")
                else:
                    consider(unattended_at)
                undecided_at = rec["submitted_us"] + self.slo_undecided_us
                if now_us >= undecided_at:
                    self._open_flag(rules.SLO_UNDECIDED, txn_id, rec, now_us,
                                    f"undecided for "
                                    f"{(now_us - rec['submitted_us']) / 1e6:.1f}s"
                                    f" ({attempts} recovery attempts)")
                else:
                    consider(undecided_at)
            elif not applied:
                unapplied_at = decided_us + self.slo_unapplied_us
                if now_us >= unapplied_at:
                    self._open_flag(rules.SLO_UNAPPLIED, txn_id, rec, now_us,
                                    f"decided "
                                    f"{(now_us - decided_us) / 1e6:.1f}s ago, "
                                    f"no replica reached APPLIED")
                else:
                    consider(unapplied_at)
        self._next_slo_check_us = next_deadline

    def _open_flag(self, kind: str, txn_id, rec: dict, now_us: int,
                   detail: str) -> None:
        key = (kind, txn_id)
        if key in self._slo_flags:
            return
        flag = {"kind": kind, "txn_id": str(txn_id), "op_id": rec["op_id"],
                "coordinator": rec["coordinator"],
                "submitted_us": rec["submitted_us"], "flagged_us": now_us,
                "detail": detail, "closed_us": None, "closed_because": None}
        self._slo_flags[key] = flag
        self._slo_history.append(flag)
        self.registry.counter(f"audit.{kind}").inc()
        if self.burnrate is not None:
            # a flag opening is one bad event on the liveness-SLO burn-rate
            # monitors (observe/burnrate.py) — the early-warning plane
            self.burnrate.on_flag_opened(kind, now_us)

    def _close_flag(self, kind: str, txn_id, now_us: int, why: str) -> None:
        flag = self._slo_flags.pop((kind, txn_id), None)
        if flag is not None:
            flag["closed_us"] = now_us
            flag["closed_because"] = why
            if self.burnrate is not None:
                self.burnrate.on_flag_closed(kind, now_us)

    # -- reporting ------------------------------------------------------------
    def open_slo_flags(self) -> List[dict]:
        return [dict(f) for f in self._slo_flags.values()]

    def slo_flag_history(self) -> List[dict]:
        return [dict(f) for f in self._slo_history]

    def verdict(self) -> dict:
        """Per-run audit summary (the burn CLI's --json per-seed verdict)."""
        out = {
            "mode": self.mode,
            "events_audited": self.events_audited,
            "violations": len(self.violations),
            "first_violation": self.violations[0].report()
            if self.violations else None,
            "rules_violated": sorted({v.rule for v in self.violations}),
            "slo_flags_raised": len(self._slo_history),
            "slo_flags_open": len(self._slo_flags),
            "open_slo_flags": self.open_slo_flags()[:16],
        }
        if self.burnrate is not None:
            # the burn-rate monitors' slo.burn events land in the SAME warn
            # stream as the flags: a soak's --json verdict carries the
            # early-warning trajectory, not just the end-state flags
            out.update(self.burnrate.report())
        return out

    def audit_report(self) -> str:
        """One-paragraph text report for the watchdog's stall dump."""
        import json
        return json.dumps(self.verdict(), sort_keys=True, default=str)
