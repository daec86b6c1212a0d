"""Device data-plane metrics: the resolver's counters and the consult
service's stats, collected into the metrics registry.

The device deps resolver's ad-hoc counters (consult tier choices, prefetch
hit/miss/patch) report through here, as do the service's queue and batching
stats.  The kernels' share of their bound is the benchmark's
(``accord_bench/metrics/*roofline_pct.py``: bytes and operations a call
needs, over the card's peaks), not a dense product's.
"""
from __future__ import annotations

from typing import Dict, Optional

from .schema import (RESOLVER_COUNTERS, RESOLVER_METRICS,
                     SERVICE_BATCH_SIZE_METRIC, SERVICE_STAT_METRICS)


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
