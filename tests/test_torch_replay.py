"""The consult-stream replay (harness/consult_trace.py, bench.py's replay
stage) of range transactions, port against reference, and the cost model's
calibration.

A 120-op burn over 1,000 keys is recorded in each package: 15% of its ops
are range reads up to 500 keys wide (harness/burn.py:330, :781-791), the
queries the walk does not take.  Each recording replays at a small T
through the four tiers.  ``ACCORD_TPU_DISPATCH_ELEMS`` pins the cost
model's threshold, so ``auto``'s routing is deterministic: past the walk,
a fused consult of B rows goes to the device when B·T·K reaches it, where
T and K are the index capacity.  The replay's consults have one row each
(B = 1), so ``auto`` runs twice: with the threshold at T·K (the wide
queries go to the device) and one element above it (they stay on the
host).  Both packages must give the same consult counts per tier and the
same answer to every query a tier answered.
"""
import math

import pytest
import torch

from cassandra_accord_tpu.harness import consult_trace as ref_ct
from cassandra_accord_tpu.impl import resolver as ref_resolver
from cassandra_accord_tpu.impl import tpu_resolver as ref_tpu
from cassandra_accord_tpu_torch.harness import consult_trace as ct
from cassandra_accord_tpu_torch.impl import resolver as port_resolver
from cassandra_accord_tpu_torch.impl import tpu_resolver as port_tpu

RECORD = dict(seed=7, ops=120, concurrency=64, batch_window_us=5000,
              nodes=3, rf=3, key_count=1000, num_shards=1, durability=True)
T_TARGET = 512
WALK_MAX = 64
# (tier, the threshold's offset from T·K)
TIERS = {"walk": ("walk", 0), "host": ("host", 0), "auto_device": ("auto", 0),
         "auto_host": ("auto", 1), "device": ("device", 0)}
QUERIES = ("key_conflicts", "range_conflicts", "max_conflict_keys",
           "max_conflict_range")
COUNTS = ("queries", "walk_consults", "host_consults", "device_consults",
          "native_consults", "parity_checked", "sampled_queries")


def _answer(a):
    return sorted(map(repr, a)) if isinstance(a, list) else repr(a)


def _replay(monkeypatch, trace_mod, resolver_cls, rec, tier, threshold):
    """One tier's scaled replay with every answer of the replayed resolver
    kept (the walk tier's resolver is the cfk walk itself, so it replays
    without the parity oracle, which is one too)."""
    answers = []

    def kept(name):
        real = getattr(resolver_cls, name)

        def call(self, *args):
            got = real(self, *args)
            answers.append((name, _answer(got)))
            return got
        return call
    with monkeypatch.context() as m:
        m.setenv("ACCORD_TPU_WALK_MAX", str(WALK_MAX))
        m.setenv("ACCORD_TPU_DISPATCH_ELEMS", str(threshold))
        for name in QUERIES:
            m.setattr(resolver_cls, name, kept(name))
        out = trace_mod.scaled_replay(
            rec, T_TARGET, [tier], parity_sample=0 if tier == "walk" else 3,
            walk_query_sample=7)
    r = out["tiers"][tier]
    return out, {c: r.get(c, 0) for c in COUNTS}, answers


@pytest.fixture(scope="module")
def recordings():
    with pytest.MonkeyPatch.context() as m:
        m.setenv("ACCORD_DEVICE", "cpu")
        m.setenv("ACCORD_TPU_WALK_MAX", str(WALK_MAX))
        ref = ref_ct.record_burn(**RECORD)
        port = ct.record_burn(**RECORD)
    return ref, port


def test_recordings_equal(recordings):
    ref, port = recordings
    assert list(map(repr, port.unit_stream())) == \
        list(map(repr, ref.unit_stream()))
    assert port.unit_peak_live() == ref.unit_peak_live()
    kinds = {ev[0] for ev in port.unit_stream()}
    assert {"rc", "mcr"} <= kinds       # range queries were recorded


@pytest.mark.parametrize("case", sorted(TIERS))
def test_replay_tier_equals_reference(case, recordings, monkeypatch):
    ref, port = recordings
    tier, above = TIERS[case]
    monkeypatch.setenv("ACCORD_DEVICE", "cpu")
    sizes = ct.scaled_replay(port, T_TARGET, [])
    threshold = sizes["txn_capacity"] * sizes["key_capacity"] + above
    cls = {"walk": (ref_resolver.CpuDepsResolver,
                    port_resolver.CpuDepsResolver)}.get(
        tier, (ref_tpu.TpuDepsResolver, port_tpu.TpuDepsResolver))
    want_out, want, want_answers = _replay(monkeypatch, ref_ct, cls[0], ref,
                                           tier, threshold)
    got_out, got, got_answers = _replay(monkeypatch, ct, cls[1], port, tier,
                                        threshold)
    assert (got_out["copies"], got_out["txn_capacity"],
            got_out["key_capacity"]) == (want_out["copies"],
                                         want_out["txn_capacity"],
                                         want_out["key_capacity"])
    assert got == want
    assert got_answers == want_answers
    assert got["queries"] > 0 and len(got_answers) > 0
    if tier != "walk":
        assert got["parity_checked"] > 0
    if tier == "auto":
        # narrow queries walk; the wide ones go where the threshold says
        assert got["walk_consults"] > 0
        on_host = got["host_consults"] + got["native_consults"]
        assert got["device_consults"] > 0 if above == 0 else \
            got["device_consults"] == 0 and on_host > 0


def test_calibrated_threshold_on_cpu_is_finite():
    got = port_tpu._calibrate_threshold(torch.device("cpu"))
    assert math.isfinite(got) and got > 1e6
    assert port_tpu._CALIBRATED["cpu"] == got
