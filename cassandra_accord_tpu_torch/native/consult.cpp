// Native host-tier consult engine.
//
// The C++ analog of TpuDepsResolver._consult_host (impl/tpu_resolver.py) and
// ops.deps_kernels.consult: answers a batch of PreAccept-class deps queries
// (SafeCommandStore.mapReduceActive, SafeCommandStore.java:292;
// cfk/CommandsForKey.java:925) plus the timestamp-proposal max
// (MaxConflicts.java:32) against the store's conflict index.
//
// Where the numpy host tier runs dense [B,K]x[K,T] BLAS matmuls (O(B*T*K)
// with f32 temporaries), this engine works over the TRANSPOSED f32 mirrors ([K,T]) in
// two phases per query: (1) the share bitmaps as an OR over the query's OWN
// key rows — contiguous streaming loads, protocol queries touch 1-3 keys —
// then (2) witness/status/timestamp checks only where the bitmap hits.
// O(B*T*k_q) sequential traffic, no temporaries, no cache thrash.  It is
// the host-side rung of the consult cost ladder between the scalar cfk walk
// and the MXU device tier.
//
// Semantics mirrored bit-for-bit (parity-tested from tests/test_native.py):
//   deps   = share_live & lex_less(txn_id, before) & witnesses[qk][k]
//            & active & (status != INVALIDATED)        over the LIVE incidence
//   max    = lane-lex max of max(ts, txn_id) where share_full & active
//            over the FULL incidence (elision never applies to MaxConflicts)
//
// Built with plain g++ (no pybind11 in the image); loaded via ctypes
// (native/__init__.py), with the numpy tier as fallback when no compiler.

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// Lexicographic a < b over `lanes` int32 lanes (all values non-negative).
static inline bool ts_less(const int32_t* a, const int32_t* b, int lanes) {
    for (int i = 0; i < lanes; ++i) {
        if (a[i] != b[i]) return a[i] < b[i];
    }
    return false;
}

// live_T / key_T: TRANSPOSED incidence, [K*T] row-major (key-major), f32 —
// the resolver's existing host-tier mirrors (0.0/1.0 values), consumed
// as-is so the native tier adds no index bookkeeping of its own.
// out_deps: [B*T] uint8 (may be null when want_deps == 0)
// out_max:  [B*lanes] int64 (may be null when want_max == 0)
// Returns 0 on success, nonzero on bad arguments / allocation failure —
// the caller must NOT read the output buffers then (a silent return would
// read as "no dependencies", a correctness failure, not a crash).
int consult_batch(const float* live_T,        // [K*T]
                   const float* key_T,        // [K*T]
                   const int32_t* ts,         // [T*lanes]
                   const int32_t* txn_id,     // [T*lanes]
                   const int8_t* kind,        // [T]
                   const int8_t* status,      // [T]
                   const uint8_t* active,     // [T]
                   int32_t T, int32_t K, int32_t lanes,
                   const int32_t* qcols,      // [B*max_q] key rows, -1 pad
                   int32_t max_q,
                   const int32_t* before,     // [B*lanes]
                   const int8_t* qkind,       // [B]
                   int32_t B,
                   const uint8_t* witnesses,  // [NK*NK] row-major
                   int32_t NK,
                   int8_t invalidated_code,
                   uint8_t want_deps,
                   uint8_t want_max,
                   uint8_t* out_deps,
                   int64_t* out_max) {
    if (lanes > 8 || lanes <= 0 || T <= 0) return 1;  // best[8] bound below
    int8_t* share_full = static_cast<int8_t*>(std::malloc(2 * (size_t)T));
    if (share_full == nullptr) return 2;
    int8_t* share_live = share_full + T;
    for (int32_t b = 0; b < B; ++b) {
        const int32_t* cols = qcols + (int64_t)b * max_q;
        int32_t ncols = 0;
        while (ncols < max_q && cols[ncols] >= 0) ++ncols;
        // phase 1: share bitmaps by streaming OR over the query's key rows
        std::memset(share_full, 0, 2 * (size_t)T);
        for (int32_t c = 0; c < ncols; ++c) {
            const float* kr = key_T + (int64_t)cols[c] * T;
            const float* lr = live_T + (int64_t)cols[c] * T;
            for (int32_t t = 0; t < T; ++t) {
                share_full[t] |= kr[t] != 0.0f;
                share_live[t] |= lr[t] != 0.0f;
            }
        }
        // phase 2: predicate checks only where the bitmaps hit
        const int32_t* bound = before + (int64_t)b * lanes;
        const uint8_t* wit_row =
            witnesses + (int64_t)(uint8_t)qkind[b] * NK;
        uint8_t* drow = want_deps ? out_deps + (int64_t)b * T : nullptr;
        if (want_deps) std::memset(drow, 0, T);
        int64_t best[8] = {0, 0, 0, 0, 0, 0, 0, 0};
        bool any = false;
        for (int32_t t = 0; t < T; ++t) {
            if (!(share_full[t] | share_live[t]) || !active[t]) continue;
            if (want_deps && share_live[t]
                    && status[t] != invalidated_code
                    && wit_row[(uint8_t)kind[t]]
                    && ts_less(txn_id + (int64_t)t * lanes, bound, lanes)) {
                drow[t] = 1;
            }
            if (want_max && share_full[t]) {
                const int32_t* slot_ts = ts + (int64_t)t * lanes;
                const int32_t* slot_id = txn_id + (int64_t)t * lanes;
                const int32_t* cand =
                    ts_less(slot_ts, slot_id, lanes) ? slot_id : slot_ts;
                bool bigger = !any;
                if (any) {
                    for (int i = 0; i < lanes; ++i) {
                        if ((int64_t)cand[i] != best[i]) {
                            bigger = (int64_t)cand[i] > best[i];
                            break;
                        }
                    }
                }
                if (bigger) {
                    for (int i = 0; i < lanes; ++i) best[i] = cand[i];
                    any = true;
                }
            }
        }
        if (want_max) {
            int64_t* mrow = out_max + (int64_t)b * lanes;
            for (int i = 0; i < lanes; ++i) mrow[i] = best[i];
        }
    }
    std::free(share_full);
    return 0;
}

}  // extern "C"
