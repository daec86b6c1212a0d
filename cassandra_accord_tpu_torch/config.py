"""LocalConfig — one injected configuration object for every tunable.

Capability parity with ``accord.config.LocalConfig``
(config/LocalConfig.java: progress-log schedule delay, epoch-fetch
timeout/watchdog — extended here with this build's read-retry and
accelerator data-plane knobs, which previously lived as ``ACCORD_*``
environment reads scattered through the tree, VERDICT r04 item 10).

``LocalConfig.from_env()`` reads the environment ONCE at construction (so
tests that monkeypatch env before building a Node/resolver keep working),
and every component takes the object — env vars are the default source, the
object is the override surface (the reference's MutableLocalConfig role)."""
from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import Optional


@dataclass
class LocalConfig:
    # -- reference knobs (config/LocalConfig.java) ---------------------------
    progress_log_poll_s: float = 0.5        # getProgressLogScheduleDelay
    epoch_fetch_initial_timeout_s: float = 10.0   # epochFetchInitialTimeout
    epoch_fetch_watchdog_interval_s: float = 10.0  # epochFetchWatchdogInterval

    # -- epoch fetch watchdog (Node._arm_epoch_watchdog) ---------------------
    epoch_fetch_retry_s: float = 1.0
    epoch_fetch_attempts: int = 30

    # -- coordination timing -------------------------------------------------
    read_retry_delay_s: float = 0.15        # transient-nack read re-round beat
    max_read_rounds: int = 3                # bounded re-rounds before Exhausted
    # speculative second read beat: sized just under the reply timeout (2s) —
    # aggressive speculation (0.6s was tried) duplicates reads under chaos
    # and flipped passing hostile seeds into the livelock class; at 1.5s it
    # fires only where it saves a whole timeout round (measured: hostile
    # seed 5 passes in 6.6s with 1.5s, 16.1s without speculation, stalls
    # at 0.6s)
    slow_read_threshold_s: float = 1.5
    investigation_stagger_s: float = 0.5    # progress-log launch stagger window

    # -- re-fencing cooperation (the seed-6 wedge) ---------------------------
    # a txn decided (stable-or-later) this many sim-seconds ago with no local
    # apply counts as "unapplied pressure" (the slo.unapplied condition); the
    # bootstrap retry ladder and staleness catch-up escalation stretch their
    # cadence by the pressure count, capped, so re-fencing never outruns
    # in-flight partial-read coverage assembly
    refence_pressure_age_s: float = 10.0
    refence_backoff_max_s: float = 30.0

    # -- elastic membership (harness/nemesis.py MembershipNemesis) -----------
    # mean sim-time between join/decommission attempts (jittered, de-aligned
    # from the other nemesis cadences); member-count bounds are derived from
    # the initial cluster size unless set
    membership_interval_s: float = 25.0
    membership_min_members: Optional[int] = None
    membership_max_members: Optional[int] = None

    # -- crash-restart nemesis (harness/nemesis.py) --------------------------
    # mean sim-time between crash attempts; each tick is jittered so crashes
    # never align with the chaos re-roll cadence
    restart_interval_s: float = 20.0
    restart_downtime_min_s: float = 2.0     # min sim-time a node stays down
    restart_downtime_max_s: float = 12.0    # max sim-time a node stays down
    restart_max_down: int = 1               # max concurrently-crashed nodes
    # never crash a node if doing so would leave ANY shard it replicates
    # without a live slow-path quorum (liveness floor; turning this off makes
    # stalls expected and is only for targeted experiments)
    restart_keep_quorum: bool = True

    # -- stall watchdog (harness/watchdog.py) --------------------------------
    stall_watchdog_interval_s: float = 5.0  # sim-time between progress checks
    stall_watchdog_after_s: float = 120.0   # sim-time with no resolved op => dump

    # -- gray-failure nemeses (harness/nemesis.py) ---------------------------
    # stop-the-world process pauses: scheduler, sinks and store executors
    # freeze; every due timer/delivery late-fires in order at resume.  The
    # cadences are deliberately de-aligned from restart_interval_s (20) and
    # the 5s chaos re-roll so fault classes overlap at seeded, shifting phases
    pause_interval_s: float = 15.0          # mean sim-time between pause attempts
    pause_min_s: float = 0.5                # min stop-the-world duration
    pause_max_s: float = 4.0                # max (> reply timeout: peers MUST
                                            # observe the node as slow-not-dead)
    pause_max_paused: int = 1               # max concurrently-paused nodes
    pause_keep_quorum: bool = True          # count paused as unavailable for
                                            # the crash/pause quorum floor
    # journal-append stalls: durability (and therefore every outbound reply —
    # fsync-before-reply) lags execution; a crash mid-stall loses the whole
    # unsynced tail
    disk_stall_interval_s: float = 17.0     # mean sim-time between stall attempts
    disk_stall_min_s: float = 1.0
    disk_stall_max_s: float = 6.0

    # -- journal integrity (harness/journal.py) ------------------------------
    # crash-time damage injection (restart nemesis): probability a crash tears
    # the tail record (partial write) / bit-flips a random record
    journal_torn_tail_chance: float = 0.25
    journal_corrupt_chance: float = 0.15
    # what restart replay does with a checksum-failed MID-LOG record (a torn
    # TAIL always silently truncates to the last whole record, like any WAL):
    # "quarantine" drops the damaged txn's records and re-enters the bootstrap
    # catch-up ladder over its footprint; "halt" raises JournalCorruption loud
    journal_corruption_policy: str = "quarantine"

    # -- adaptive reply timeout/backoff (harness/cluster.py sink) ------------
    # the first timeout is reply_timeout_s; every non-final-reply re-arm grows
    # by reply_backoff_factor (capped, with deterministic hash jitter so
    # re-arms across nodes never phase-lock), and after reply_rearm_budget
    # re-arms the last armed timer stands un-re-armed (bounded patience)
    reply_backoff_factor: float = 2.0
    reply_backoff_max_s: float = 30.0
    reply_backoff_jitter: float = 0.25      # fraction of the timeout, [0, j)
    reply_rearm_budget: int = 8

    # -- slow-replica tracking (read-speculation routing) --------------------
    # a peer is "slow" while its reply-latency EWMA exceeds the threshold or
    # within the penalty window after a reply timeout; coordinators route
    # per-shard data reads around slow peers instead of burning timeout rounds
    slow_peer_ewma_alpha: float = 0.3
    slow_peer_latency_threshold_s: float = 1.0
    slow_peer_penalty_s: float = 5.0

    # -- overload robustness (local/overload.py) ------------------------------
    # admission control: a node sheds NEW work (replica-side PreAccepts via a
    # fast Overloaded nack; harness clients check before dispatching) while
    # its composite load signal — outstanding RPC callbacks + unapplied
    # execution pressure — sits above the high watermark, until it drains
    # below the low watermark (hysteresis).  Default OFF: with the default
    # config every trajectory is byte-identical to the pre-overload tree.
    admission_enabled: bool = False
    admission_hi: int = 48                  # shed at/above this composite load
    admission_lo: int = 32                  # readmit at/below this (hysteresis)
    admission_pressure_age_s: float = 5.0   # unapplied-pressure age horizon
    # coordinator routing: after an Overloaded nack (or a piggybacked load
    # bit) the peer counts as slow for this window — reads route around it
    overload_penalty_s: float = 2.0
    # replies piggyback the replica's current overload bit so coordinators
    # learn of pressure without waiting for a shed (only consulted when
    # admission is enabled)
    backpressure_piggyback: bool = True
    # retry budgets: deterministic token buckets (hash-jittered refill, zero
    # RNG-stream consumption) gate the unbounded retry surfaces — progress-log
    # investigation/blocked-fetch launches and the bootstrap re-fencing
    # ladder.  A denied launch defers to the next poll/rung instead of
    # joining a herd.  Default OFF.
    # defaults sized to bind only on storms: a store's normal recovery drain
    # runs tens of investigations per sim-second — a budget tighter than that
    # throttles the HEAL rate and manufactures the very goodput collapse it
    # exists to prevent (measured on the round-14 ramp oracle: rate 4/s
    # stretched the post-overload drain tail 2-3x)
    retry_budget_enabled: bool = False
    retry_budget_rate_s: float = 32.0       # tokens per sim-second
    retry_budget_burst: float = 64.0        # bucket capacity
    retry_budget_jitter: float = 0.25       # refill-rate jitter fraction

    # -- columnar protocol engine (protocol_batch/) ---------------------------
    # struct-of-arrays txn batches over command-store hot state + vectorized
    # release/frontier/progress scans.  "off" keeps every legacy code path
    # untouched; "on"/"auto" enable the engine — which by the exact-skip
    # contract NEVER changes a protocol decision (same-seed burns on-vs-off
    # are byte-identical; the knob buys wall-clock, never trajectory)
    columnar: str = "auto"                  # auto | on | off

    # -- deps-resolver data plane (impl/resolver.py, impl/tpu_resolver.py) ---
    resolver_kind: str = "cpu"              # cpu | tpu | verify
    tpu_txn_slots: int = 64
    tpu_key_slots: int = 64
    tpu_tier: str = "auto"                  # auto | host | device | walk
    tpu_walk_max: int = 384                 # index size below which walk always
    tpu_walk_width: int = 8                 # narrow-query walk routing width
    tpu_f32_max: int = 16384                # persistent f32 mirror bound
    tpu_host_engine: str = "auto"           # auto | numpy | native
    tpu_dispatch_elems: Optional[float] = None  # device-tier threshold override

    # -- persistent batched device consult service (device_service/) ---------
    # "auto"/"on": the resolver's device tier routes through the persistent
    # service (incremental double-buffered index refresh, ragged batching
    # window, futures API); "off": legacy one-shot dispatch (whole-index
    # re-upload per consult — the r05 replay wedge; kept as a bench baseline)
    tpu_service: str = "auto"               # auto | on | off
    # torch = the consult kernels on the tensors' device (the hand-written
    # CUDA kernels on the card, their plain torch versions when the caller
    # asked for the CPU — both count as the kernel tier); host =
    # deterministic numpy (bit-identical answers, dispatched eagerly per
    # window); auto = torch
    tpu_service_backend: str = "auto"       # auto | torch | host
    tpu_service_max_window: int = 256       # row-bucket cap per dispatch
    tpu_service_refresh_full_frac: float = 0.25  # dirty fraction -> full upload

    # -- where the device tier runs (device.py) -------------------------------
    # "cuda" (or "cuda:N") puts the index and every consult on the card and
    # raises when there is none; "cpu" must be asked for (tests, CPU hosts)
    device: str = "cuda"

    _ENV_FIELDS = (
        ("ACCORD_RESTART_INTERVAL", "restart_interval_s", float),
        ("ACCORD_RESTART_DOWNTIME_MIN", "restart_downtime_min_s", float),
        ("ACCORD_RESTART_DOWNTIME_MAX", "restart_downtime_max_s", float),
        ("ACCORD_RESTART_MAX_DOWN", "restart_max_down", int),
        ("ACCORD_STALL_WATCHDOG_AFTER", "stall_watchdog_after_s", float),
        ("ACCORD_PAUSE_INTERVAL", "pause_interval_s", float),
        ("ACCORD_PAUSE_MAX", "pause_max_s", float),
        ("ACCORD_DISK_STALL_INTERVAL", "disk_stall_interval_s", float),
        ("ACCORD_MEMBERSHIP_INTERVAL", "membership_interval_s", float),
        ("ACCORD_JOURNAL_CORRUPTION", "journal_corruption_policy",
         lambda v: v.lower()),
        ("ACCORD_JOURNAL_TORN_TAIL_CHANCE", "journal_torn_tail_chance", float),
        ("ACCORD_JOURNAL_CORRUPT_CHANCE", "journal_corrupt_chance", float),
        ("ACCORD_ADMISSION", "admission_enabled",
         lambda v: v.lower() not in ("", "0", "off", "false")),
        ("ACCORD_ADMISSION_HI", "admission_hi", int),
        ("ACCORD_ADMISSION_LO", "admission_lo", int),
        ("ACCORD_OVERLOAD_PENALTY", "overload_penalty_s", float),
        ("ACCORD_RETRY_BUDGET", "retry_budget_enabled",
         lambda v: v.lower() not in ("", "0", "off", "false")),
        ("ACCORD_RETRY_BUDGET_RATE", "retry_budget_rate_s", float),
        ("ACCORD_RETRY_BUDGET_BURST", "retry_budget_burst", float),
        ("ACCORD_REPLY_BACKOFF_MAX", "reply_backoff_max_s", float),
        ("ACCORD_REPLY_REARM_BUDGET", "reply_rearm_budget", int),
        ("ACCORD_COLUMNAR", "columnar", lambda v: v.lower()),
        ("ACCORD_RESOLVER", "resolver_kind", lambda v: v.lower()),
        ("ACCORD_TPU_TXN_SLOTS", "tpu_txn_slots", int),
        ("ACCORD_TPU_KEY_SLOTS", "tpu_key_slots", int),
        ("ACCORD_TPU_TIER", "tpu_tier", str),
        ("ACCORD_TPU_WALK_MAX", "tpu_walk_max", int),
        ("ACCORD_TPU_WALK_WIDTH", "tpu_walk_width", int),
        ("ACCORD_TPU_F32_MAX", "tpu_f32_max", int),
        ("ACCORD_TPU_HOST_TIER", "tpu_host_engine", str),
        ("ACCORD_TPU_DISPATCH_ELEMS", "tpu_dispatch_elems", float),
        ("ACCORD_TPU_SERVICE", "tpu_service", lambda v: v.lower()),
        ("ACCORD_TPU_SERVICE_BACKEND", "tpu_service_backend",
         lambda v: v.lower()),
        ("ACCORD_TPU_SERVICE_MAX_WINDOW", "tpu_service_max_window", int),
        ("ACCORD_DEVICE", "device", lambda v: v.lower()),
    )

    @classmethod
    def from_env(cls, **overrides) -> "LocalConfig":
        # kwargs ONLY for env vars actually set: the dataclass field defaults
        # stay the single source of truth
        kw = {}
        for var, field, conv in cls._ENV_FIELDS:
            raw = os.environ.get(var)
            if raw is not None:
                kw[field] = conv(raw)
        kw.update(overrides)
        return cls(**kw)
