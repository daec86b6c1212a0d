"""explain — divergence forensics over two causal provenance dumps of the
PyTorch port.

The twin of ``tools/explain.py`` with its import pointed at
``cassandra_accord_tpu_torch`` (a test holds the two equal, imports aside).
It takes two ``--provenance`` dumps (``observe/provenance.py`` ``save()``
format, version 1) from same-seed runs and reports WHERE the trajectories
causally departed: the causally-first divergent event over the full causal
stream, the first message-trace divergence (the byte-level symptom, for
contrast), and the divergent event's bounded ancestor cone.

Usage:
    python tools_torch/explain.py ref-prov.json other-prov.json [--hops N]

Producing the inputs, e.g. the host backend against the card:
    ACCORD_RESOLVER=tpu ACCORD_TPU_TIER=device ACCORD_TPU_WALK_MAX=0 \
    ACCORD_TPU_WALK_WIDTH=0 ACCORD_TPU_SERVICE=on \
    ACCORD_TPU_SERVICE_BACKEND=host \
    python -m cassandra_accord_tpu_torch.harness.burn --seeds 0 --ops 120 \
        --audit=strict --provenance host-prov.json
    # ... the same with ACCORD_TPU_SERVICE_BACKEND=torch writes card-prov.json

Stdout TAIL contract (as ``tools/explain.py``): the LAST stdout line is one
compact single-line JSON object (identical-or-not, divergence index + sim
time, both events' kind/what, cone size).  Exit code: 0 = identical,
3 = divergent.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO_ROOT not in sys.path:
    sys.path.insert(0, _REPO_ROOT)

from cassandra_accord_tpu_torch.observe.provenance import (  # noqa: E402
    ProvenanceRecorder, explain_divergence)

_TAIL_WHAT_CHARS = 160   # per-event description budget in the JSON tail


def _tail_event(ev: dict) -> dict:
    """Compact one aligned event for the tail line (bounded description)."""
    if ev is None:
        return None
    return {"kind": ev.get("kind"), "sim_us": ev.get("sim_us"),
            "what": str(ev.get("what", ""))[:_TAIL_WHAT_CHARS]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="explain",
        description="report the causally-first divergent event between two "
                    "provenance dumps, plus its ancestor cone")
    p.add_argument("reference", help="provenance dump of the reference run "
                                     "(run a)")
    p.add_argument("other", help="provenance dump of the suspect run (run b)")
    p.add_argument("--hops", type=int, default=10,
                   help="ancestor-cone depth in parent hops (default 10)")
    args = p.parse_args(argv)

    a = ProvenanceRecorder.load(args.reference)
    b = ProvenanceRecorder.load(args.other)
    rep = explain_divergence(a, b, hops=args.hops)

    tail = {"reference": os.path.basename(args.reference),
            "other": os.path.basename(args.other),
            "events_a": len(a["events"]), "events_b": len(b["events"]),
            "hops": args.hops}
    if rep is None:
        print("causal DAGs are identical "
              f"({len(a['events'])} events each)", flush=True)
        tail.update(identical=True)
        print(json.dumps(tail, sort_keys=True), flush=True)
        return 0
    print(rep["text"], flush=True)
    msg = rep.get("first_message_divergence")
    tail.update(
        identical=False, index=rep["index"], sim_us=rep["sim_us"],
        event_a=_tail_event(rep.get("event_a")),
        event_b=_tail_event(rep.get("event_b")),
        origin=_tail_event(rep.get("origin")),
        first_message_divergence_seq=msg.get("seq") if msg else None,
        cone_events=len(rep.get("cone") or []))
    line = json.dumps(tail, sort_keys=True)
    if len(line) >= 4096:   # tail contract: survive a bounded capture
        for k in ("origin", "event_a", "event_b"):
            if tail.get(k):
                tail[k] = {"kind": tail[k]["kind"]}
        line = json.dumps(tail, sort_keys=True)
    print(line, flush=True)
    return 3


if __name__ == "__main__":
    sys.exit(main())
