"""Device data-plane metrics: one source for resolver counters and kernel
roofline accounting.

The device deps resolver's ad-hoc counters (consult tier choices, prefetch
hit/miss/patch) and the kernel-level roofline numbers (join operations,
index bytes, share of the card's peak) previously lived in two places — burn-result stats and
``bench.py`` JSON tails — with the formulas duplicated.  Both now report
through here.
"""
from __future__ import annotations

from typing import Dict, Optional

from .schema import (RESOLVER_COUNTERS, RESOLVER_METRICS,
                     SERVICE_BATCH_SIZE_METRIC, SERVICE_STAT_METRICS)

# The consult kernels (csrc/consult.cu) run byte ORs and int32 compares on
# the CUDA cores; they use no tensor cores.  The denominator is therefore
# the H100 SXM's non-tensor rate: 67 TFLOP/s FP32 on CUDA cores (NVIDIA H100
# Tensor Core GPU data sheet, SXM column, at the 700 W power limit).  The
# "join operations" below count 2·B·K·T, the work of the equivalent dense
# product, so the share says how far the sparse kernel is past doing that
# product at the card's CUDA-core rate, not how busy the card was.
PEAK_CUDA_CORE_TFLOPS = 67.0


def resolver_counters(resolver) -> Optional[Dict[str, int]]:
    """The standard counter dict for one store's resolver (unwrapping the
    verify resolver to its device half), or None when the store runs a plain
    host resolver with no telemetry."""
    r = getattr(resolver, "tpu", resolver)
    if not hasattr(r, RESOLVER_COUNTERS[0]):
        return None
    return {name: getattr(r, name) for name in RESOLVER_COUNTERS}


def cluster_resolver_totals(cluster) -> Dict[str, int]:
    """Sum of every store's resolver counters (the burn-result telemetry
    block).  Zero-filled keys when no telemetry-bearing resolver exists so
    callers can test ``any(tel.values())``."""
    totals = {name: 0 for name in RESOLVER_COUNTERS}
    for node in cluster.nodes.values():
        for store in node.command_stores.all_stores():
            counters = resolver_counters(store.resolver)
            if counters is not None:
                for name, value in counters.items():
                    totals[name] += value
    return totals


def service_of(resolver):
    """The store's DeviceConsultService, if one was ever engaged (unwraps
    the verify resolver); None otherwise."""
    r = getattr(resolver, "tpu", resolver)
    return getattr(r, "_service_obj", None)


def cluster_services(cluster):
    """Every engaged per-store consult service in the cluster."""
    out = []
    for node in cluster.nodes.values():
        for store in node.command_stores.all_stores():
            svc = service_of(store.resolver)
            if svc is not None:
                out.append((node.id, store.id, svc))
    return out


def collect_into(registry, cluster) -> None:
    """Pull-collect per-store resolver counters (and cluster totals) into a
    MetricsRegistry as gauges under the schema's ``resolver.*`` names, plus
    the consult-service stats under ``service.*`` (queue/batching behavior:
    batch-size histogram, window occupancy, dispatch latency, refresh
    traffic)."""
    totals = {name: 0 for name in RESOLVER_COUNTERS}
    seen = False
    for node in cluster.nodes.values():
        for store in node.command_stores.all_stores():
            counters = resolver_counters(store.resolver)
            if counters is None:
                continue
            seen = True
            for name, value in counters.items():
                registry.gauge(RESOLVER_METRICS[name], node=node.id,
                               store=store.id).set(value)
                totals[name] += value
    if seen:
        for name, value in totals.items():
            registry.gauge(RESOLVER_METRICS[name]).set(value)
    for node_id, store_id, svc in cluster_services(cluster):
        stats = svc.stats()
        for name, metric in SERVICE_STAT_METRICS.items():
            registry.gauge(metric, node=node_id, store=store_id) \
                .set(stats[name])
        # batch sizes are bounded by the window row cap (default 256): pow2
        # bounds, NOT the sim-time latency defaults (everything would land
        # in the first 1000us bucket)
        hist = registry.histogram(SERVICE_BATCH_SIZE_METRIC, node=node_id,
                                  store=store_id,
                                  bounds=(1, 2, 4, 8, 16, 32, 64, 128, 256))
        # record only the DELTA since this service was last collected:
        # collect_cluster runs again on the failure path (and on any later
        # metrics_snapshot), and Histogram.record is additive
        reported = getattr(svc, "_hist_reported", None)
        if reported is None:
            reported = svc._hist_reported = {}
        for rows, count in svc.batch_size_hist.items():
            delta = count - reported.get(rows, 0)
            if delta > 0:
                hist.record_many(rows, delta)
            reported[rows] = count


# -- kernel roofline accounting (bench.py) -----------------------------------

def consult_join_flops(b: int, k: int, t: int) -> float:
    """Matmul FLOPs of one fused consult launch: a [B,K]x[K,T] join."""
    return 2.0 * b * k * t


def index_bytes_int8(t: int, k: int) -> int:
    """Resident bytes of the int8 incidence index (key_inc + live mirror)."""
    return 2 * t * k


def kernel_consult_metrics(t: int, k: int, b: int,
                           device_qps: float) -> Dict[str, float]:
    """Roofline block for one consult-kernel measurement: achieved join
    TFLOP/s and its share of the card's CUDA-core peak."""
    tflops = device_qps / b * consult_join_flops(b, k, t) / 1e12
    return {"index_bytes_int8": index_bytes_int8(t, k),
            "device_join_tflops": round(tflops, 4),
            "consult_peak_share": round(tflops / PEAK_CUDA_CORE_TFLOPS, 5)}


def launch_mfu(t: int, k: int, rows: int, seconds: float) -> Dict[str, float]:
    """Share of peak of one measured consult launch (the wall profiler's
    per-launch plane): achieved join TFLOP/s of a [rows,K]x[K,T] join over
    its measured wall seconds, against the CUDA-core peak — same
    denominator as ``kernel_consult_metrics``, one formula source."""
    tflops = consult_join_flops(max(rows, 1), k, t) / max(seconds, 1e-9) / 1e12
    return {"launch_join_tflops": round(tflops, 5),
            "launch_peak_share": round(tflops / PEAK_CUDA_CORE_TFLOPS, 7)}
