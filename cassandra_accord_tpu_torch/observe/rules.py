"""The protocol-invariant rule catalog: the auditor's legal-edge table and
rule names.

Like ``observe/schema.py``, the tables here are written out EXPLICITLY (not
derived from the enums or the transition code) on purpose: the tier-1 lint
(``tests/test_audit.py``) asserts exact two-way agreement with the
``SaveStatus`` enum — every member must appear as a source and as a target of
at least one legal edge — so a new phase cannot ship unaudited, and a stale
entry for a removed member fails tier-1 too.

Edge provenance (each edge names the ``local/commands.py`` path that takes
it; the auditor flags anything else as ``RULE_ILLEGAL_EDGE``):

- ``preaccept``: NOT_DEFINED -> PRE_ACCEPTED.
- ``accept``: {NOT_DEFINED, PRE_ACCEPTED, ACCEPTED_INVALIDATE, ACCEPTED} ->
  ACCEPTED (the self-edge is a higher-ballot re-accept; the
  ACCEPTED_INVALIDATE source is a later-ballot Accept superseding an
  invalidation vote).
- ``accept_invalidate``: {NOT_DEFINED, PRE_ACCEPTED} -> ACCEPTED_INVALIDATE
  (guarded ``save_status < ACCEPTED_INVALIDATE``, so never from ACCEPTED+).
- ``precommit``: anything undecided -> PRE_COMMITTED.
- ``commit``: anything below the target tier (and not truncated/invalidated)
  -> COMMITTED / STABLE.
- ``maybe_execute``: STABLE -> READY_TO_EXECUTE; PRE_APPLIED -> APPLYING;
  ``_apply_writes`` then APPLYING -> APPLIED.
- ``apply_``: anything below PRE_APPLIED (not truncated/invalidated) ->
  PRE_APPLIED.
- ``commit_invalidate``: only NEVER-pre-committed states -> INVALIDATED (a
  decided txn arriving here is the agent-escalated "committed AND
  invalidated" impossibility, and is additionally caught cross-replica by
  ``RULE_COMMIT_INVALIDATE_CONFLICT``).
- ``truncate`` / ``adopt_truncated_outcome``: any pre-PRE_APPLIED state (the
  adoption guard) or APPLIED (GC) -> TRUNCATED_APPLY; the ERASE tier ->
  ERASED (GC of universally-durable applied txns; the never-committed
  below-fence erase; ``install_quarantine_tombstone``'s fresh tombstone).
- terminal self-edges (APPLIED, TRUNCATED_APPLY, ERASED, INVALIDATED,
  NOT_DEFINED): duplicate re-observations — journal replay re-reports a
  rebuilt command's tier, and repeated truncation refreshes a tombstone.
  They carry no state change and are explicitly legal.

Journal-replay semantics: a restart rebuilds a store from its durable tier,
which may sit ANYWHERE at or below the pre-crash status (the crash loses the
volatile tail).  The auditor therefore re-baselines a node's per-store
lifecycle state at ``crash`` and treats the replay window's first
re-observation of each txn as its new baseline rather than an edge.
"""
from __future__ import annotations

from ..local.status import SaveStatus

# -- rule names (the catalog; README "Auditing" documents each) --------------

RULE_ILLEGAL_EDGE = "save_status.illegal_edge"
RULE_EXECUTE_AT_MISMATCH = "commit.execute_at_mismatch"
RULE_EXECUTE_AT_MUTATED = "commit.execute_at_mutated"
RULE_DEPS_MISMATCH = "commit.deps_mismatch"
RULE_DEPS_MUTATED = "stable.deps_mutated"
RULE_COMMIT_INVALIDATE_CONFLICT = "commit.invalidate_conflict"
RULE_EXECUTE_AT_DUPLICATE = "commit.execute_at_not_unique"
RULE_BALLOT_REGRESSION = "ballot.regression"
RULE_KEY_EXECUTE_AT_ORDER = "key.execute_at_order"
RULE_DURABILITY_REGRESSION = "durability.watermark_regression"
RULE_EPOCH_REGRESSION = "epoch.regression"
RULE_SYNC_LEDGER_REGRESSION = "epoch.sync_ledger_regression"

SAFETY_RULES = (
    RULE_ILLEGAL_EDGE,
    RULE_EXECUTE_AT_MISMATCH,
    RULE_EXECUTE_AT_MUTATED,
    RULE_DEPS_MISMATCH,
    RULE_DEPS_MUTATED,
    RULE_COMMIT_INVALIDATE_CONFLICT,
    RULE_EXECUTE_AT_DUPLICATE,
    RULE_BALLOT_REGRESSION,
    RULE_KEY_EXECUTE_AT_ORDER,
    RULE_DURABILITY_REGRESSION,
    RULE_EPOCH_REGRESSION,
    RULE_SYNC_LEDGER_REGRESSION,
)

# liveness SLO flag classes (flags, never raises — see observe/audit.py)
SLO_UNATTENDED = "slo.unattended"    # undecided past budget, no attempt attributed
SLO_UNDECIDED = "slo.undecided"      # undecided past the (larger) decision budget
SLO_UNAPPLIED = "slo.unapplied"      # decided long ago, never applied anywhere

SLO_FLAGS = (SLO_UNATTENDED, SLO_UNDECIDED, SLO_UNAPPLIED)

# -- the legal-edge table (source name -> frozenset of target names) ---------

LEGAL_EDGES = {
    "NOT_DEFINED": frozenset({
        "NOT_DEFINED",              # replay re-observation of a journal stub
        "PRE_ACCEPTED", "ACCEPTED_INVALIDATE", "ACCEPTED", "PRE_COMMITTED",
        "COMMITTED", "STABLE", "PRE_APPLIED", "INVALIDATED",
        "TRUNCATED_APPLY", "ERASED",
    }),
    "PRE_ACCEPTED": frozenset({
        "ACCEPTED_INVALIDATE", "ACCEPTED", "PRE_COMMITTED", "COMMITTED",
        "STABLE", "PRE_APPLIED", "INVALIDATED", "TRUNCATED_APPLY", "ERASED",
    }),
    "ACCEPTED_INVALIDATE": frozenset({
        "ACCEPTED", "PRE_COMMITTED", "COMMITTED", "STABLE", "PRE_APPLIED",
        "INVALIDATED", "TRUNCATED_APPLY", "ERASED",
    }),
    "ACCEPTED": frozenset({
        "ACCEPTED",                 # higher-ballot re-accept
        "PRE_COMMITTED", "COMMITTED", "STABLE", "PRE_APPLIED", "INVALIDATED",
        "TRUNCATED_APPLY", "ERASED",
    }),
    "PRE_COMMITTED": frozenset({
        "COMMITTED", "STABLE", "PRE_APPLIED", "TRUNCATED_APPLY", "ERASED",
    }),
    "COMMITTED": frozenset({
        "STABLE", "PRE_APPLIED", "TRUNCATED_APPLY", "ERASED",
    }),
    "STABLE": frozenset({
        "READY_TO_EXECUTE", "PRE_APPLIED", "TRUNCATED_APPLY", "ERASED",
    }),
    "READY_TO_EXECUTE": frozenset({
        "PRE_APPLIED", "TRUNCATED_APPLY", "ERASED",
    }),
    "PRE_APPLIED": frozenset({
        "APPLYING", "TRUNCATED_APPLY", "ERASED",
    }),
    "APPLYING": frozenset({
        "APPLIED", "TRUNCATED_APPLY", "ERASED",
    }),
    "APPLIED": frozenset({
        "APPLIED",                  # replay re-observation
        "TRUNCATED_APPLY", "ERASED",
    }),
    "TRUNCATED_APPLY": frozenset({
        "TRUNCATED_APPLY",          # tombstone refresh / replay re-observation
        "ERASED",
    }),
    "ERASED": frozenset({
        "ERASED",                   # tombstone refresh / replay re-observation
    }),
    "INVALIDATED": frozenset({
        "INVALIDATED",              # replay re-observation
    }),
}


def is_legal_edge(frm: str, to: str) -> bool:
    targets = LEGAL_EDGES.get(frm)
    return targets is not None and to in targets


def lint_legal_edges() -> list:
    """Two-way completeness check of the edge table against the SaveStatus
    enum (the CI-lint satellite; tests turn a nonempty return into a tier-1
    failure).  Every member must be a source (have at least one outgoing
    edge) and a target (appear in at least one edge's target set); every
    name in the table must be a real member."""
    problems = []
    members = {s.name for s in SaveStatus}
    missing_source = sorted(members - set(LEGAL_EDGES))
    if missing_source:
        problems.append(f"SaveStatus members with no source row in "
                        f"LEGAL_EDGES: {missing_source}")
    stale = sorted(set(LEGAL_EDGES) - members)
    if stale:
        problems.append(f"LEGAL_EDGES rows for nonexistent SaveStatus "
                        f"members: {stale}")
    all_targets = set()
    for src, targets in LEGAL_EDGES.items():
        if not targets:
            problems.append(f"LEGAL_EDGES[{src}] has no outgoing edges "
                            f"(every member must be a source)")
        bad = sorted(set(targets) - members)
        if bad:
            problems.append(f"LEGAL_EDGES[{src}] targets nonexistent "
                            f"members: {bad}")
        all_targets.update(targets)
    missing_target = sorted(members - all_targets)
    if missing_target:
        problems.append(f"SaveStatus members never a target of any legal "
                        f"edge: {missing_target}")
    return problems
