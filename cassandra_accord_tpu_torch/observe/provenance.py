"""Causal provenance: the per-run event DAG behind divergence forensics.

``harness/trace.py`` answers *what* the simulation did — a flat,
byte-comparable list of message-plane events.  This module answers *why*:
every recorded event carries up to two parent edges,

- an **execution parent** (``p1``): the activity — handler, reply callback,
  timer fire, reply timeout — that was running when the event was emitted,
  and for a timer fire, the activity that *armed* it;
- a **message parent** (``p2``): the previous event of the same ``msg_id``
  (a RECV's parent is its send; a reply's parent is the request delivery it
  answers), i.e. wire causality.

Together these form a DAG over a strict superset of the message trace:
handler executions, timer fires, reply callbacks/timeouts, save-status
transitions and crash/restart injections are first-class events too, which
is exactly what makes the forensics *causal* — the origin of a divergence
(a crash that dropped no packet, a timer that fired late) is often invisible
in the byte trace and only exists here.

Zero observer effect: the recorder is a pure side table.  It never touches
RNG, wall clock, or the event loop; the message trace's event tuples are
byte-identical with provenance on vs off (``tests/test_provenance.py``
proves it the PR-3 way, same-seed hostile burn + ``diff_traces``).  Message
events additionally keep their trace sequence number — ``seq_to_pid`` is the
side table keyed by trace seq the rest of the tree joins against.

On top of the DAG:

- :func:`explain_divergence` aligns two same-seed runs' DAGs, names the
  earliest *causally*-divergent event (over the full event superset, not
  merely the first differing trace byte) and walks its ancestor cone back
  to the last shared decision;
- :meth:`ProvenanceRecorder.slice_for` renders a bounded k-hop backward
  slice from a transaction's latest transition — the forensic attachment
  ``AuditViolation``, history-checker anomalies and watchdog stall dumps
  embed.
"""
from __future__ import annotations

import json
from typing import Optional

from ..harness.trace import _brief

# event tuple layout (plain tuples: millions of these exist in long burns)
E_PID, E_KIND, E_US, E_P1, E_P2, E_NAME, E_FRM, E_TO, E_MSG, E_DETAIL = \
    range(10)

# kinds
K_MSG = "msg"              # one message-plane trace event (carries trace seq)
K_HANDLER = "handler"      # Node._process_or_fail executing one request
K_CALLBACK = "callback"    # a reply callback firing (SimMessageSink)
K_TIMEOUT = "timeout"      # a reply timeout firing (SimMessageSink)
K_TIMER = "timer"          # a NodeScheduler timer firing
K_TRANSITION = "transition"  # a save-status transition (_observe_transition)
K_CRASH = "crash"          # nemesis/perturbation fault-in
K_RESTART = "restart"

_RECV_EVENTS = ("RECV", "RECV_RPLY")


def _describe(ev) -> str:
    """One-line human rendering of an event tuple."""
    kind = ev[E_KIND]
    if kind == K_MSG:
        return (f"{ev[E_NAME]} {ev[E_FRM]}->{ev[E_TO]} "
                f"#{ev[E_MSG]} {ev[E_DETAIL]}")
    if kind == K_HANDLER:
        return f"handler {ev[E_NAME]}({ev[E_DETAIL]}) @node{ev[E_TO]}"
    if kind == K_CALLBACK:
        return f"reply-callback #{ev[E_MSG]} @node{ev[E_TO]}"
    if kind == K_TIMEOUT:
        return f"reply-timeout #{ev[E_MSG]} @node{ev[E_TO]}"
    if kind == K_TIMER:
        return f"timer @node{ev[E_TO]}"
    if kind == K_TRANSITION:
        return (f"{ev[E_DETAIL]} -> {ev[E_NAME]} "
                f"@node{ev[E_TO]}/store{ev[E_FRM]}")
    return f"{kind} node{ev[E_TO]}"   # crash / restart


def describe_event(ev) -> dict:
    """JSON-ready rendering of one event (slice/report element)."""
    return {"pid": ev[E_PID], "kind": ev[E_KIND], "sim_us": ev[E_US],
            "parents": [p for p in (ev[E_P1], ev[E_P2]) if p is not None],
            "what": _describe(ev)}


def _content_key(ev):
    """Alignment key: everything positional (pid, parents, msg_id — global
    allocation order) excluded, so two runs' events compare by *what
    happened when*, not by bookkeeping ids."""
    return (ev[E_KIND], ev[E_US], ev[E_NAME], ev[E_FRM], ev[E_TO],
            ev[E_DETAIL])


class ProvenanceRecorder:
    """The per-run causal DAG side table.

    Rides a ``FlightRecorder`` as the ``provenance=`` attachment (like
    ``timeline``/``burnrate``); the cluster and node brackets feed the
    execution-context stack, the message hooks feed the wire chains.
    """

    def __init__(self):
        self.events: list = []           # event tuples, pid == index
        self.seq_to_pid: list = []       # trace seq -> pid (the side table)
        self._ctx: list = []             # execution-context stack of pids
        # only an IMMEDIATELY-following handler/callback bracket may claim a
        # delivery as its cause; any interleaved event clears it
        self._pending_recv: Optional[int] = None
        self._msg_chain: dict = {}       # msg_id -> pid of its latest event
        self._last_txn_event: dict = {}  # str(txn_id) -> pid
        self._last_transition: dict = {} # (node, store, str(txn_id)) -> pid

    # -- recording ------------------------------------------------------------
    def _add(self, kind, now_us, p1, p2, name, frm, to, msg_id, detail) -> int:
        pid = len(self.events)
        self.events.append((pid, kind, now_us, p1, p2, name, frm, to,
                            msg_id, detail))
        return pid

    def current(self) -> Optional[int]:
        """The pid of the innermost running activity (timer-arm capture)."""
        return self._ctx[-1] if self._ctx else None

    def on_message_event(self, event: str, frm: int, to: int, msg_id,
                         message, now_us: int) -> None:
        p1 = self._ctx[-1] if self._ctx else None
        p2 = self._msg_chain.get(msg_id)
        pid = self._add(K_MSG, now_us, p1, p2, event, frm, to, msg_id,
                        _brief(message))
        self.seq_to_pid.append(pid)
        if msg_id is not None:
            self._msg_chain[msg_id] = pid
        self._pending_recv = pid if event in _RECV_EVENTS else None
        txn = getattr(message, "txn_id", None)
        if txn is not None:
            self._last_txn_event[str(txn)] = pid

    def begin_handler(self, node: int, request_type: str, txn_id,
                      now_us: int) -> None:
        p2 = self._pending_recv
        self._pending_recv = None
        p1 = self._ctx[-1] if self._ctx else None
        detail = str(txn_id) if txn_id is not None else ""
        pid = self._add(K_HANDLER, now_us, p1, p2, request_type, None, node,
                        None, detail)
        if txn_id is not None:
            self._last_txn_event[detail] = pid
        self._ctx.append(pid)

    def begin_callback(self, node: int, msg_id, txn_id, now_us: int) -> None:
        p2 = self._pending_recv
        self._pending_recv = None
        if p2 is None:
            p2 = self._msg_chain.get(msg_id)
        p1 = self._ctx[-1] if self._ctx else None
        pid = self._add(K_CALLBACK, now_us, p1, p2, "callback", None, node,
                        msg_id, str(txn_id) if txn_id is not None else "")
        self._ctx.append(pid)

    def begin_timeout(self, node: int, msg_id, txn_id, now_us: int) -> None:
        self._pending_recv = None
        p2 = self._msg_chain.get(msg_id)
        pid = self._add(K_TIMEOUT, now_us, None, p2, "timeout", None, node,
                        msg_id, str(txn_id) if txn_id is not None else "")
        self._ctx.append(pid)

    def begin_timer(self, node: int, armed_by: Optional[int],
                    now_us: int) -> None:
        self._pending_recv = None
        pid = self._add(K_TIMER, now_us, armed_by, None, "timer", None, node,
                        None, "")
        self._ctx.append(pid)

    def end(self) -> None:
        """Close the innermost bracket (handler/callback/timeout/timer)."""
        if self._ctx:
            self._ctx.pop()
        self._pending_recv = None

    def on_transition(self, node: int, store: int, txn_id, status_name: str,
                      now_us: int) -> None:
        p1 = self._ctx[-1] if self._ctx else None
        key = str(txn_id)
        pid = self._add(K_TRANSITION, now_us, p1, None, status_name, store,
                        node, None, key)
        self._last_txn_event[key] = pid
        self._last_transition[(node, store, key)] = pid

    def on_crash(self, node_id: int, now_us: int) -> None:
        p1 = self._ctx[-1] if self._ctx else None
        self._pending_recv = None
        self._add(K_CRASH, now_us, p1, None, K_CRASH, None, node_id, None, "")

    def on_restart(self, node_id: int, now_us: int) -> None:
        p1 = self._ctx[-1] if self._ctx else None
        self._pending_recv = None
        self._add(K_RESTART, now_us, p1, None, K_RESTART, None, node_id,
                  None, "")

    # -- queries --------------------------------------------------------------
    def ancestors(self, pid: int, hops: int = 8) -> list:
        """Pids of the bounded backward cone of ``pid`` (k-hop BFS over both
        parent kinds), sorted ascending; includes ``pid`` itself."""
        seen = {pid}
        frontier = [pid]
        for _ in range(hops):
            nxt = []
            for p in frontier:
                ev = self.events[p]
                for parent in (ev[E_P1], ev[E_P2]):
                    if parent is not None and parent not in seen:
                        seen.add(parent)
                        nxt.append(parent)
            if not nxt:
                break
            frontier = nxt
        return sorted(seen)

    def anchor_for(self, txn_id=None, node=None, store=None) -> Optional[int]:
        """The pid forensics should slice backward from: the txn's latest
        transition at (node, store) if known, else its latest transition
        anywhere, else its latest event of any kind."""
        key = str(txn_id) if txn_id is not None else None
        if key is not None and node is not None and store is not None:
            pid = self._last_transition.get((node, store, key))
            if pid is not None:
                return pid
        if key is not None:
            best = None
            for (_n, _s, k), pid in self._last_transition.items():
                if k == key and (best is None or pid > best):
                    best = pid
            if best is not None:
                return best
            return self._last_txn_event.get(key)
        return len(self.events) - 1 if self.events else None

    def slice_for(self, txn_id=None, node=None, store=None,
                  hops: int = 8) -> Optional[dict]:
        """The bounded k-hop backward causal slice embedded in violation
        reports and stall dumps: the anchor event (the bad transition) plus
        its ancestor cone, each sim-timestamped and rendered."""
        anchor = self.anchor_for(txn_id=txn_id, node=node, store=store)
        if anchor is None:
            return None
        cone = self.ancestors(anchor, hops=hops)
        return {"anchor_pid": anchor, "hops": hops,
                "events": [describe_event(self.events[p]) for p in cone]}

    def tail_summary(self, limit: int = 12) -> dict:
        """The recorder's recent tail (stall dumps when no txn is singled
        out): the last ``limit`` events, rendered."""
        tail = self.events[-limit:]
        return {"events_total": len(self.events),
                "tail": [describe_event(ev) for ev in tail]}

    # -- serialization ("--provenance" artifact / "--explain-vs" input) -------
    def to_doc(self) -> dict:
        return {"version": 1, "events": [list(ev) for ev in self.events]}

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_doc(), f, separators=(",", ":"))

    @staticmethod
    def load(path: str) -> dict:
        with open(path) as f:
            doc = json.load(f)
        if doc.get("version") != 1 or "events" not in doc:
            raise ValueError(f"{path}: not a provenance dump")
        return doc


def _event_list(run) -> list:
    """Accept a ProvenanceRecorder or a loaded dump doc."""
    if isinstance(run, ProvenanceRecorder):
        return run.events
    return run["events"]


def _cone(events: list, pid: int, hops: int) -> list:
    seen = {pid}
    frontier = [pid]
    for _ in range(hops):
        nxt = []
        for p in frontier:
            ev = events[p]
            for parent in (ev[E_P1], ev[E_P2]):
                if parent is not None and parent not in seen:
                    seen.add(parent)
                    nxt.append(parent)
        if not nxt:
            break
        frontier = nxt
    return sorted(seen)


def explain_divergence(a, b, hops: int = 10) -> Optional[dict]:
    """Align two same-seed runs' causal DAGs and explain their divergence.

    Deterministic runs share a byte-identical prefix, so alignment is by
    position over the *full* causal event stream (messages AND handlers,
    timers, transitions, crash/restart injections), comparing content keys
    that exclude bookkeeping ids.  The first index where the keys differ is
    the **causally first** divergent event — it can precede the first
    differing message-trace byte by a long way (an injected crash that
    dropped no packet, a delayed timer) because those causes never appear
    on the wire.

    Returns ``None`` when the runs are causally identical, else a report:

    - ``event_a``/``event_b``: the divergent pair (either side ``None`` if
      that run simply ended);
    - ``first_message_divergence``: the first differing *message* event and
      its trace seq — the byte-level symptom, for contrast;
    - ``cone``: the divergent event's bounded ancestor cone, each member
      marked ``shared`` (still in the common prefix — the causal run-up)
      or ``divergent`` (post-fork consequence);
    - ``origin``: the nearest shared ancestor — the last decision both runs
      agreed on before the trajectories forked;
    - ``text``: the human-readable rendering.
    """
    ea, eb = _event_list(a), _event_list(b)
    n = min(len(ea), len(eb))
    idx = None
    for i in range(n):
        if _content_key(ea[i]) != _content_key(eb[i]):
            idx = i
            break
    if idx is None:
        if len(ea) == len(eb):
            return None
        idx = n   # one run is a strict prefix of the other

    event_a = ea[idx] if idx < len(ea) else None
    event_b = eb[idx] if idx < len(eb) else None

    # first differing MESSAGE event (the byte-plane symptom): positional
    # over each run's msg-kind subsequence, i.e. trace-seq alignment
    ma = [ev for ev in ea if ev[E_KIND] == K_MSG]
    mb = [ev for ev in eb if ev[E_KIND] == K_MSG]
    first_msg = None
    for j in range(min(len(ma), len(mb))):
        if _content_key(ma[j]) != _content_key(mb[j]):
            first_msg = {"seq": j,
                         "event_a": describe_event(ma[j]),
                         "event_b": describe_event(mb[j])}
            break
    if first_msg is None and len(ma) != len(mb):
        j = min(len(ma), len(mb))
        longer = ma if len(ma) > len(mb) else mb
        side = "event_a" if len(ma) > len(mb) else "event_b"
        first_msg = {"seq": j, side: describe_event(longer[j])}

    # the divergent event's ancestor cone, walked in the run that HAS it
    cone_events, cone_run = (eb, "b") if event_b is not None else (ea, "a")
    divergent = event_b if event_b is not None else event_a
    cone = []
    origin = None
    if divergent is not None:
        for p in _cone(cone_events, divergent[E_PID], hops):
            d = describe_event(cone_events[p])
            d["shared"] = p < idx     # prefix events exist in both runs
            if d["shared"] and (origin is None or p > origin["pid"]):
                origin = d
            cone.append(d)

    lines = [f"causal divergence at event {idx}"
             + (f" (sim {divergent[E_US]}us)" if divergent is not None
                else "")]
    lines.append(f"  run a: "
                 + (_describe(event_a) if event_a is not None else "<ended>"))
    lines.append(f"  run b: "
                 + (_describe(event_b) if event_b is not None else "<ended>"))
    if first_msg is not None:
        lines.append(f"first message-trace divergence at seq "
                     f"{first_msg['seq']} (the byte-level symptom):")
        for side in ("event_a", "event_b"):
            if side in first_msg:
                lines.append(f"  run {side[-1]}: {first_msg[side]['what']} "
                             f"(sim {first_msg[side]['sim_us']}us)")
    else:
        lines.append("message traces are byte-identical: the divergence is "
                     "causal-plane only (timer/handler/fault ordering)")
    if origin is not None:
        lines.append(f"origin (last shared decision): {origin['what']} "
                     f"(sim {origin['sim_us']}us, pid {origin['pid']})")
    lines.append(f"ancestor cone of the divergent event (run {cone_run}, "
                 f"<= {hops} hops):")
    for d in cone:
        tag = "shared   " if d["shared"] else "divergent"
        lines.append(f"  [{tag}] pid {d['pid']:>7} sim {d['sim_us']:>12}us "
                     f"{d['what']}")

    return {"index": idx,
            "sim_us": divergent[E_US] if divergent is not None else None,
            "event_a": describe_event(event_a) if event_a is not None else None,
            "event_b": describe_event(event_b) if event_b is not None else None,
            "first_message_divergence": first_msg,
            "origin": origin,
            "cone": cone,
            "text": "\n".join(lines)}


def render_slice(sl: Optional[dict]) -> str:
    """Human rendering of a ``slice_for`` result (KNOWN_ISSUES ledgers,
    stall dumps)."""
    if sl is None:
        return "<no provenance anchor>"
    lines = [f"causal slice (anchor pid {sl['anchor_pid']}, "
             f"<= {sl['hops']} hops):"]
    for d in sl["events"]:
        mark = "*" if d["pid"] == sl["anchor_pid"] else " "
        lines.append(f" {mark} pid {d['pid']:>7} sim {d['sim_us']:>12}us "
                     f"{d['what']}")
    return "\n".join(lines)
