"""Multi-window SLO burn-rate monitors: mid-run early warning for soaks.

The auditor's liveness-SLO plane and the watchdog both answer AFTER the fact
— a flag names a stuck txn once its budget lapses, the watchdog kills the
burn once NOTHING has resolved for minutes.  Large-cluster soak burns need
the signal in between: *the error budget is burning fast enough that this
run is headed for a wedge*, minutes before the watchdog's exit.

This is the classic SRE multi-window burn-rate construction, transplanted
onto SIMULATED time so it stays deterministic:

- an SLO defines which events are BAD (a commit slower than the latency SLO,
  an auditor liveness flag opening) against a stream of GOOD events (commits
  inside the SLO);
- the **burn rate** over a window is ``bad_fraction / error_budget`` — 1.0
  means the budget burns exactly at its sustainable rate, 10 means ten times
  too fast;
- a monitor fires only when BOTH a short window and a long window exceed the
  threshold (the standard two-window guard: the long window proves it is not
  a blip, the short window proves it is still happening), with a minimum
  bad-event count so a single unlucky txn cannot page.

Every fired episode is a deterministic ``slo.burn`` event (sim-timestamped,
opened/cleared like the auditor's flags): it lands in the monitor's event
list, in the registry as an ``slo.burn.<name>`` counter, on the timeline
(when one is attached) as a windowed rate, in the auditor's ``verdict()``
(the burn CLI's ``--json`` warn stream), and in the watchdog's stall dump.
``tests/test_burnrate.py`` proves the acceptance shape: on an injected
journal-stall wedge the monitor fires strictly earlier (sim time) than the
watchdog's stall exit, and it stays silent across the clean matrix.

Zero observer effect: the monitor consumes sim-timestamps and outcomes the
recorder hooks already carry — no RNG, no wall clock, no scheduling.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional, Tuple


class SloSpec:
    """One SLO and its burn-rate alerting policy.

    ``kind``: ``"latency"`` — resolutions are the event stream, bad when the
    commit latency exceeds ``latency_slo_us`` (or the op failed outright);
    ``"liveness"`` — bad pressure is the count of CURRENTLY-OPEN auditor
    SLO flags (a flag opens once but a wedge holds it open — the open set,
    not the opening edge, is the sustained signal), judged against the
    windowed resolution stream as the good events: a wedge starves the good
    stream while flags stay open, driving the bad fraction to 1.0 in the
    short window first and in the long window once the pre-wedge
    resolutions age out."""

    __slots__ = ("name", "kind", "budget", "short_us", "long_us",
                 "burn_threshold", "min_bad", "latency_slo_us")

    def __init__(self, name: str, kind: str, budget: float,
                 short_s: float = 5.0, long_s: float = 30.0,
                 burn_threshold: float = 10.0, min_bad: int = 3,
                 latency_slo_us: int = 5_000_000):
        assert kind in ("latency", "liveness"), kind
        assert 0.0 < budget < 1.0, "budget is an error fraction"
        assert short_s < long_s, "the short window must be shorter"
        self.name = name
        self.kind = kind
        self.budget = budget
        self.short_us = int(short_s * 1_000_000)
        self.long_us = int(long_s * 1_000_000)
        self.burn_threshold = burn_threshold
        self.min_bad = min_bad
        self.latency_slo_us = latency_slo_us


# Defaults tuned for burn-harness scale (sim-seconds, tens-to-hundreds of
# ops): the latency SLO allows 5 sim-seconds per commit with a 5% budget —
# benign runs sit orders of magnitude below it — and the liveness SLO burns
# on auditor flag openings against a 2% budget.  A threshold of 10 with both
# windows agreeing means the budget is burning >= 10x too fast NOW and has
# been for a full long window.
DEFAULT_SLOS = (
    SloSpec("commit_latency", "latency", budget=0.05,
            short_s=5.0, long_s=30.0, burn_threshold=10.0, min_bad=5,
            latency_slo_us=5_000_000),
    SloSpec("liveness", "liveness", budget=0.02,
            short_s=5.0, long_s=30.0, burn_threshold=10.0, min_bad=3),
)


class BurnRateMonitor:
    """Deterministic multi-window burn-rate evaluation over recorder hooks.

    Attach via ``FlightRecorder(burnrate=BurnRateMonitor())`` (or the burn
    CLI's ``--burnrate``); the recorder feeds resolutions, the auditor feeds
    flag openings, and every message event pulses the sim clock so the
    monitor can evaluate between resolutions (a total wedge produces no
    resolutions at all — the probes and timeouts still pulse)."""

    def __init__(self, specs: Tuple[SloSpec, ...] = DEFAULT_SLOS):
        self.specs = tuple(specs)
        # per spec: deque of (sim_us, is_bad) pruned to the long window
        self._events: Dict[str, Deque[Tuple[int, bool]]] = {
            s.name: deque() for s in self.specs}
        self.events: List[dict] = []          # fired slo.burn episodes
        self._open: Dict[str, dict] = {}      # name -> currently-burning event
        self._open_flags: Dict[str, int] = {}  # auditor flag kind -> open count
        self._next_check_us: Optional[int] = None
        self._recorder = None                 # bound by FlightRecorder

    # -- wiring ---------------------------------------------------------------
    def bind(self, recorder) -> None:
        self._recorder = recorder

    # -- feeding (recorder/auditor hooks) -------------------------------------
    def on_resolution(self, outcome: str, latency_us: Optional[int],
                      now_us: int) -> None:
        for spec in self.specs:
            if spec.kind == "latency":
                bad = outcome == "failed" or (
                    latency_us is not None and latency_us > spec.latency_slo_us)
                self._events[spec.name].append((now_us, bad))
            else:   # liveness: resolutions are the GOOD stream
                self._events[spec.name].append((now_us, False))
        # Resolutions are the hot path (hundreds/sim-s at drain): the event
        # is recorded above regardless, so evaluation can ride the same
        # cadence guard as on_pulse instead of rescanning the windows on
        # every commit.  Flag edges stay immediate — they are rare and an
        # open/close can change the verdict by itself.
        if self._next_check_us is not None and now_us < self._next_check_us:
            return
        self._check(now_us)

    def on_flag_opened(self, flag_kind: str, now_us: int) -> None:
        """An auditor liveness-SLO flag opened (slo.unattended / undecided /
        unapplied): the open-flag pressure the liveness SLOs burn on."""
        self._open_flags[flag_kind] = self._open_flags.get(flag_kind, 0) + 1
        self._check(now_us)

    def on_flag_closed(self, flag_kind: str, now_us: int) -> None:
        """The flag's condition cleared (decided / applied / resolved)."""
        count = self._open_flags.get(flag_kind, 0)
        if count > 1:
            self._open_flags[flag_kind] = count - 1
        else:
            self._open_flags.pop(flag_kind, None)
        self._check(now_us)

    def on_pulse(self, now_us: int) -> None:
        """Clock pulse from the message plane: evaluate if the check cadence
        elapsed (cheap guard — one integer compare on the hot path)."""
        if self._next_check_us is not None and now_us < self._next_check_us:
            return
        self._check(now_us)

    # -- evaluation -----------------------------------------------------------
    def _rates(self, spec: SloSpec, now_us: int) -> Tuple[float, float, int]:
        """(short_burn_rate, long_burn_rate, bad_count) for one spec.

        ``latency``: both counts come from the windowed event stream.
        ``liveness``: bad is the INSTANTANEOUS open-flag count (state, not
        an edge — it applies to both windows), good the windowed
        resolutions."""
        events = self._events[spec.name]
        long_lo = now_us - spec.long_us
        while events and events[0][0] < long_lo:
            events.popleft()
        short_lo = now_us - spec.short_us
        good_l = bad_l = good_s = bad_s = 0
        for ts, is_bad in events:
            if is_bad:
                bad_l += 1
                if ts >= short_lo:
                    bad_s += 1
            else:
                good_l += 1
                if ts >= short_lo:
                    good_s += 1
        if spec.kind == "liveness":
            open_flags = sum(self._open_flags.values())
            bad_s = bad_l = open_flags

        def burn(bad, good):
            total = bad + good
            if not total:
                return 0.0
            return (bad / total) / spec.budget
        return burn(bad_s, good_s), burn(bad_l, good_l), bad_s

    def _check(self, now_us: int) -> None:
        min_short = min(s.short_us for s in self.specs)
        self._next_check_us = now_us + max(min_short // 4, 1)
        for spec in self.specs:
            short, long_, bad_s = self._rates(spec, now_us)
            burning = (short >= spec.burn_threshold
                       and long_ >= spec.burn_threshold
                       and bad_s >= spec.min_bad)
            open_ev = self._open.get(spec.name)
            if burning and open_ev is None:
                event = {"kind": "slo.burn", "slo": spec.name,
                         "sim_us": now_us,
                         "short_burn_rate": round(short, 2),
                         "long_burn_rate": round(long_, 2),
                         "short_window_s": spec.short_us / 1e6,
                         "long_window_s": spec.long_us / 1e6,
                         "burn_threshold": spec.burn_threshold,
                         "cleared_us": None}
                self._open[spec.name] = event
                self.events.append(event)
                self._emit(spec, now_us)
            elif not burning and open_ev is not None:
                open_ev["cleared_us"] = now_us
                del self._open[spec.name]

    def _emit(self, spec: SloSpec, now_us: int) -> None:
        """Fan the firing out to the recorder's other planes (registry
        counter, timeline rate) — all deterministic bookkeeping."""
        rec = self._recorder
        if rec is None:
            return
        rec.registry.counter(f"slo.burn.{spec.name}").inc()
        timeline = getattr(rec, "timeline", None)
        if timeline is not None:
            timeline.count(f"slo.burn.{spec.name}", now_us)

    # -- reporting ------------------------------------------------------------
    def open_burns(self) -> List[dict]:
        return [dict(e) for e in self._open.values()]

    def report(self) -> dict:
        """Plane summary for verdicts / stall dumps."""
        return {
            "slo_burn_events": len(self.events),
            "open_slo_burns": sorted(self._open),
            "first_slo_burn": dict(self.events[0]) if self.events else None,
            "last_slo_burn": dict(self.events[-1]) if self.events else None,
        }
