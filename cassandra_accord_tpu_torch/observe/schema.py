"""The canonical metric-name schema — the registry completeness contract.

Every wire ``MessageType`` and every ``Status``/``SaveStatus`` member has an
EXPLICIT entry here.  The dicts are written out (not derived from the enums)
on purpose: ``tests/test_observe.py`` asserts exact two-way agreement with
the enums, so a NEW message type or status phase cannot ship unobserved —
adding the enum member without a metric name fails tier-1, and a stale entry
for a removed/renamed member fails it too.
"""
from __future__ import annotations

# -- message plane (messages/base.py MessageType) ----------------------------

MESSAGE_METRICS = {
    "SIMPLE_RSP": "msg.simple_rsp",
    "FAILURE_RSP": "msg.failure_rsp",
    "PRE_ACCEPT_REQ": "msg.pre_accept_req",
    "PRE_ACCEPT_RSP": "msg.pre_accept_rsp",
    "ACCEPT_REQ": "msg.accept_req",
    "ACCEPT_RSP": "msg.accept_rsp",
    "ACCEPT_INVALIDATE_REQ": "msg.accept_invalidate_req",
    "GET_DEPS_REQ": "msg.get_deps_req",
    "GET_DEPS_RSP": "msg.get_deps_rsp",
    "GET_EPHEMERAL_READ_DEPS_REQ": "msg.get_ephemeral_read_deps_req",
    "GET_EPHEMERAL_READ_DEPS_RSP": "msg.get_ephemeral_read_deps_rsp",
    "GET_MAX_CONFLICT_REQ": "msg.get_max_conflict_req",
    "GET_MAX_CONFLICT_RSP": "msg.get_max_conflict_rsp",
    "COMMIT_SLOW_PATH_REQ": "msg.commit_slow_path_req",
    "COMMIT_MAXIMAL_REQ": "msg.commit_maximal_req",
    "STABLE_FAST_PATH_REQ": "msg.stable_fast_path_req",
    "STABLE_SLOW_PATH_REQ": "msg.stable_slow_path_req",
    "STABLE_MAXIMAL_REQ": "msg.stable_maximal_req",
    "COMMIT_INVALIDATE_REQ": "msg.commit_invalidate_req",
    "APPLY_MINIMAL_REQ": "msg.apply_minimal_req",
    "APPLY_MAXIMAL_REQ": "msg.apply_maximal_req",
    "APPLY_RSP": "msg.apply_rsp",
    "READ_REQ": "msg.read_req",
    "READ_EPHEMERAL_REQ": "msg.read_ephemeral_req",
    "READ_RSP": "msg.read_rsp",
    "BEGIN_RECOVER_REQ": "msg.begin_recover_req",
    "BEGIN_RECOVER_RSP": "msg.begin_recover_rsp",
    "BEGIN_INVALIDATE_REQ": "msg.begin_invalidate_req",
    "BEGIN_INVALIDATE_RSP": "msg.begin_invalidate_rsp",
    "WAIT_ON_COMMIT_REQ": "msg.wait_on_commit_req",
    "WAIT_ON_COMMIT_RSP": "msg.wait_on_commit_rsp",
    "WAIT_UNTIL_APPLIED_REQ": "msg.wait_until_applied_req",
    "APPLY_THEN_WAIT_UNTIL_APPLIED_REQ":
        "msg.apply_then_wait_until_applied_req",
    "RECOVER_AWAIT_REQ": "msg.recover_await_req",
    "CHECK_STATUS_REQ": "msg.check_status_req",
    "CHECK_STATUS_RSP": "msg.check_status_rsp",
    "FETCH_DATA_REQ": "msg.fetch_data_req",
    "FETCH_DATA_RSP": "msg.fetch_data_rsp",
    "SET_SHARD_DURABLE_REQ": "msg.set_shard_durable_req",
    "SET_GLOBALLY_DURABLE_REQ": "msg.set_globally_durable_req",
    "QUERY_DURABLE_BEFORE_REQ": "msg.query_durable_before_req",
    "QUERY_DURABLE_BEFORE_RSP": "msg.query_durable_before_rsp",
    "INFORM_OF_TXN_REQ": "msg.inform_of_txn_req",
    "FIND_ROUTE_REQ": "msg.find_route_req",
    "FIND_ROUTE_RSP": "msg.find_route_rsp",
    "INFORM_DURABLE_REQ": "msg.inform_durable_req",
    "INFORM_HOME_DURABLE_REQ": "msg.inform_home_durable_req",
    "PROPAGATE_PRE_ACCEPT_MSG": "msg.propagate_pre_accept_msg",
    "PROPAGATE_STABLE_MSG": "msg.propagate_stable_msg",
    "PROPAGATE_APPLY_MSG": "msg.propagate_apply_msg",
    "PROPAGATE_OTHER_MSG": "msg.propagate_other_msg",
}

# -- txn status lattice (local/status.py) ------------------------------------

STATUS_METRICS = {
    "NOT_DEFINED": "txn.status.not_defined",
    "PRE_ACCEPTED": "txn.status.pre_accepted",
    "ACCEPTED_INVALIDATE": "txn.status.accepted_invalidate",
    "ACCEPTED": "txn.status.accepted",
    "PRE_COMMITTED": "txn.status.pre_committed",
    "COMMITTED": "txn.status.committed",
    "STABLE": "txn.status.stable",
    "PRE_APPLIED": "txn.status.pre_applied",
    "APPLIED": "txn.status.applied",
    "TRUNCATED": "txn.status.truncated",
    "INVALIDATED": "txn.status.invalidated",
}

SAVE_STATUS_METRICS = {
    "NOT_DEFINED": "txn.save_status.not_defined",
    "PRE_ACCEPTED": "txn.save_status.pre_accepted",
    "ACCEPTED_INVALIDATE": "txn.save_status.accepted_invalidate",
    "ACCEPTED": "txn.save_status.accepted",
    "PRE_COMMITTED": "txn.save_status.pre_committed",
    "COMMITTED": "txn.save_status.committed",
    "STABLE": "txn.save_status.stable",
    "READY_TO_EXECUTE": "txn.save_status.ready_to_execute",
    "PRE_APPLIED": "txn.save_status.pre_applied",
    "APPLYING": "txn.save_status.applying",
    "APPLIED": "txn.save_status.applied",
    "TRUNCATED_APPLY": "txn.save_status.truncated_apply",
    "ERASED": "txn.save_status.erased",
    "INVALIDATED": "txn.save_status.invalidated",
}

# -- coordinator-side resolution classes (harness/burn.py resolve kinds) -----
# Every submitted op resolves as exactly ONE of these; the flight recorder's
# span accounting asserts sum(outcomes) == submitted (tier-1).

OUTCOMES = ("fast", "slow", "recovered", "invalidated", "lost", "failed")
OUTCOME_METRICS = {o: f"txn.resolved.{o}" for o in OUTCOMES}
# the outcome classes that ARE commits — the critical-path extractor's
# admission set and the windowed commits/s curve sum over the same tuple
COMMIT_OUTCOMES = ("fast", "slow", "recovered")

SUBMITTED_METRIC = "txn.submitted"
LATENCY_METRIC = "txn.latency_us"

# -- device data plane (impl/tpu_resolver.py counters) -----------------------

RESOLVER_COUNTERS = ("prefetch_hits", "prefetch_patched", "prefetch_misses",
                     "walk_consults", "host_consults", "native_consults",
                     "device_consults", "service_submitted", "service_batches")
RESOLVER_METRICS = {c: f"resolver.{c}" for c in RESOLVER_COUNTERS}

# -- persistent batched device consult service (device_service/) -------------
# per-store gauges collected from DeviceConsultService.stats(); the
# batch-size distribution additionally lands in a sim-registry histogram and
# the queue-depth/batch-rows samples become Chrome-trace counter tracks
SERVICE_STAT_METRICS = {
    "submitted": "service.submitted",
    "answered": "service.answered",
    "oneshot_rows": "service.oneshot_rows",
    "batches": "service.batches",
    "dropped_windows": "service.dropped_windows",
    # NOTE: dispatch_mean_s/dispatch_max_s (wall-clock) stay OUT of the
    # registry on purpose — snapshots are diffed across same-seed runs and
    # must not carry always-differing wall-clock floats; the bench and the
    # replay harness read them from DeviceConsultService.stats() directly
    "mean_batch_rows": "service.mean_batch_rows",
    "window_occupancy": "service.window_occupancy",
    "jit_shapes": "service.jit_shapes",
    "index_full_uploads": "service.index_full_uploads",
    "index_incremental_refreshes": "service.index_incremental_refreshes",
    "index_rows_uploaded": "service.index_rows_uploaded",
    "samples_dropped": "service.samples_dropped",
}
SERVICE_BATCH_SIZE_METRIC = "service.batch_size"


# -- store-scope pull-collected gauges (FlightRecorder.collect_cluster) ------

STORE_GAUGE_METRICS = {
    "commands": "store.commands",
    "cold": "store.cold",
    "exec_deferred": "store.exec_deferred",
    "cache_miss_loads": "store.cache_miss_loads",
    "tfk_inversions": "store.tfk_inversions",
}

# -- timeline-only series (observe/timeline.py; never in the registry) -------
# the windowed in-flight gauge is maintained by the flight recorder's own
# submit/resolve envelope (submitted - resolved), sampled into the timeline

TIMELINE_IN_FLIGHT_METRIC = "txn.in_flight"

# -- timeline policy declarations ---------------------------------------------
# Every metric the schema registers declares how the sim-time timeline
# (observe/timeline.py) treats it — its TIMELINE POLICY:
#
#   ``rate``       event-stream counter: per-window increment count + rate/s
#   ``sample``     gauge: last value observed inside each window
#   ``percentile`` value stream: per-window exact p50/p95/p99 (nearest-rank)
#   ``excluded``   no per-event stream exists (end-of-run pull-collected
#                  gauges) or the series is deliberately not windowed
#
# Two-way linted (tests/test_observe.py) against the metric tables above,
# exactly like METRIC_UNITS: a new schema metric without a policy fails
# tier-1, and so does a stale policy entry for a removed metric.  The
# Timeline enforces the declaration at feed time — feeding an ``excluded``
# metric, or feeding with the wrong verb, raises.

TIMELINE_POLICY_VALUES = ("rate", "sample", "percentile", "excluded")

TIMELINE_POLICIES = {
    SUBMITTED_METRIC: "rate",
    LATENCY_METRIC: "percentile",
    TIMELINE_IN_FLIGHT_METRIC: "sample",
    SERVICE_BATCH_SIZE_METRIC: "percentile",
    **{name: "rate" for name in OUTCOME_METRICS.values()},
    # pull-collected end-of-run gauges: there is no per-event stream to
    # window (the consult-service QUEUE trajectory is windowed separately
    # from its deterministic (ts, depth, rows) samples — timeline.py
    # service_window_records)
    **{name: "excluded" for name in RESOLVER_METRICS.values()},
    **{name: "excluded" for name in SERVICE_STAT_METRICS.values()},
    **{name: "excluded" for name in STORE_GAUGE_METRICS.values()},
}

# dynamic metric families resolve by prefix (same pattern as
# METRIC_UNIT_PREFIXES); explicit entries take precedence
TIMELINE_POLICY_PREFIXES = {
    "msg.": "rate",              # MESSAGE_METRICS + msg.received/unregistered
    "link.": "rate",
    "net.": "rate",
    "txn.status.": "rate",
    "txn.save_status.": "rate",
    "txn.path.": "rate",
    "txn.fastpath.": "rate",
    "recovery.": "rate",
    "progress.": "rate",
    "lifecycle.": "rate",
    "slo.": "rate",              # burn-rate monitor firings (observe/burnrate)
    "overload.": "rate",         # admission nacks/sheds + retry-budget
                                 # denials (local/overload.py, harness/burn)
    "audit.": "excluded",        # violation counters: forensic, not windowed
    "sim.": "excluded",          # pull-collected cluster.stats mirror
}


def timeline_policy_for(metric_name: str) -> str:
    """Declared timeline policy for a metric; KeyError (with the fix) for an
    undeclared one — the lint test turns that into a tier-1 failure."""
    policy = TIMELINE_POLICIES.get(metric_name)
    if policy is not None:
        return policy
    for prefix, policy in TIMELINE_POLICY_PREFIXES.items():
        if metric_name.startswith(prefix):
            return policy
    raise KeyError(
        f"metric {metric_name!r} declares no timeline policy: add it to "
        f"observe/schema.py TIMELINE_POLICIES "
        f"(rate | sample | percentile | excluded)")


# -- unit / time-plane declarations -------------------------------------------
# Every HISTOGRAM and GAUGE metric declares its unit, which doubles as its
# time-plane declaration: ``sim_s`` values are simulated time (deterministic,
# diffable across same-seed runs), ``wall_s`` is host time (NEVER allowed in
# the registry — snapshots are diffed across same-seed runs; the wall plane
# lives in observe/profiler.py reports), ``bytes`` / ``count`` are plane-free
# magnitudes.  Two-way linted (tests/test_observe.py) against the metric
# tables above, exactly like the MessageType / SaveStatus completeness
# checks: a new gauge/histogram without a unit fails tier-1, and so does a
# stale unit entry for a removed metric.  ``sim.*`` gauges mirror dynamic
# simulator-stat keys (message-class counts, fault injections) and are
# covered by the prefix table.

UNITS = ("sim_s", "wall_s", "bytes", "count")

METRIC_UNITS = {
    LATENCY_METRIC: "sim_s",
    SERVICE_BATCH_SIZE_METRIC: "count",
    **{name: "count" for name in RESOLVER_METRICS.values()},
    **{name: "count" for name in SERVICE_STAT_METRICS.values()},
    **{name: "count" for name in STORE_GAUGE_METRICS.values()},
}

METRIC_UNIT_PREFIXES = {
    "sim.": "count",        # pull-collected cluster.stats mirror (dynamic)
}


def unit_for(metric_name: str) -> str:
    """Declared unit/time-plane for a gauge or histogram metric; KeyError
    (with the fix) for an undeclared one — the lint test turns that into a
    tier-1 failure."""
    unit = METRIC_UNITS.get(metric_name)
    if unit is not None:
        return unit
    for prefix, unit in METRIC_UNIT_PREFIXES.items():
        if metric_name.startswith(prefix):
            return unit
    raise KeyError(
        f"metric {metric_name!r} declares no unit/time plane: add it to "
        f"observe/schema.py METRIC_UNITS (sim_s | wall_s | bytes | count)")


def metric_for_message(type_name: str) -> str:
    """Registry name for a MessageType member; KeyError (with the fix) for an
    unregistered one — the lint test turns that into a tier-1 failure."""
    try:
        return MESSAGE_METRICS[type_name]
    except KeyError:
        raise KeyError(
            f"MessageType.{type_name} has no metric name: add it to "
            f"observe/schema.py MESSAGE_METRICS") from None


def metric_for_save_status(status_name: str) -> str:
    try:
        return SAVE_STATUS_METRICS[status_name]
    except KeyError:
        raise KeyError(
            f"SaveStatus.{status_name} has no metric name: add it to "
            f"observe/schema.py SAVE_STATUS_METRICS") from None
