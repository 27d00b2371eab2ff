// Copied unchanged from native/enqueuekernel.cc of the repository (the reference
// package's host pass); only this header is new.  Built by
// riak_ensemble_tpu_torch/ops/build.py (load_host) with g++ into one
// shared library under riak_ensemble_tpu_torch/build/.

// Native half of the service's ENQUEUE path (the sibling of
// resolvekernel.cc, compiled into the same _retpu_resolve.so under
// the same utils/native.py loader discipline: plain-C ABI, ctypes,
// pure-Python fallback stays the oracle — RETPU_NATIVE_ENQUEUE=0).
//
// PR 7 moved the per-flush RESOLVE hot loop to C; its latency
// breakdown then showed the remaining host cost on the other side of
// the device round: packing the pending queue entries into the
// [K, E] op planes and fanning the results back out.  The service
// keeps each flush's pending ops as a PENDING SLAB — per-entry run
// descriptors (ensemble column, first plane row, run length, uniform
// kind) over concatenated per-op field lanes (slot, value/handle,
// CAS-expectation halves) — and this kernel walks the runs in ONE
// C++ traversal each way:
//
//   1. retpu_enqueue_pack    — pending slab -> the five [K, E] int32
//      op planes (replacing the per-entry numpy slice-assignment
//      walk).  Run descriptors, not flat per-op row/col lanes, so
//      the Python->C conversion cost scales with ENTRIES, not ops.
//   2. retpu_enqueue_gather  — result planes -> the per-flush
//      COMPLETION SLAB ([R] records in taken order: committed,
//      get_ok, found, value, vsn), replacing per-op scalar reads /
//      per-entry column slices at settle.
//
// Contract: outputs are BIT-IDENTICAL to the numpy fallback's
// (tests/test_native_enqueue.py sweeps the equivalence); pack planes
// arrive zero-initialized (padding rows and idle columns stay
// NOOP/zero exactly as the fallback leaves them).  A run outside the
// [K, E] grid returns -1 — the caller rebuilds through the numpy
// path, which raises the honest error.

#include <cstdint>

extern "C" {

// ABI version for stale-.so detection (utils/native.py probes the
// symbol; enqueue_native.py refuses < 2 — v1 took flat per-op
// row/col lanes).
int retpu_enqueue_version(void) { return 2; }

// Scatter the pending slab's runs into the five [K, E] int32 op
// planes.  Per entry i: rows [row0[i], row0[i]+len[i]) of column
// col[i] take kind[i] (uniform per entry — batches are one op kind)
// and the next len[i] values of each field lane (an RMW entry's expe
// carries its mod-fun table code, val its int32 operand — the exact
// field layout flush() always packed).
int retpu_enqueue_pack(int64_t n_ent, int32_t k, int32_t e,
                       const int32_t* col, const int32_t* row0,
                       const int32_t* len, const int32_t* kind,
                       const int32_t* slot, const int32_t* val,
                       const int32_t* expe, const int32_t* exps,
                       int32_t* kind_p, int32_t* slot_p,
                       int32_t* val_p, int32_t* expe_p,
                       int32_t* exps_p) {
  if (!col || !row0 || !len || !kind || !slot || !val || !expe ||
      !exps || !kind_p || !slot_p || !val_p || !expe_p || !exps_p) {
    return -1;
  }
  int64_t off = 0;
  for (int64_t i = 0; i < n_ent; i++) {
    const int32_t c = col[i];
    const int32_t r0 = row0[i];
    const int32_t n = len[i];
    if (c < 0 || c >= e || n < 0 || r0 < 0 || r0 + n > k) {
      return -1;
    }
    const int32_t kd = kind[i];
    for (int32_t j = 0; j < n; j++, off++) {
      const int64_t p = static_cast<int64_t>(r0 + j) * e + c;
      kind_p[p] = kd;
      slot_p[p] = slot[off];
      val_p[p] = val[off];
      expe_p[p] = expe[off];
      exps_p[p] = exps[off];
    }
  }
  return 0;
}

// Gather the flush's result planes through the same runs into the
// completion slab: out_* are preallocated [R] (vsn: [R, 2]) arrays
// in taken order.  committed/get_ok/found are numpy bool (u8)
// planes; value int32 [K, E]; vsn int32 [K, E, 2].
int retpu_enqueue_gather(int64_t n_ent, int32_t k, int32_t e,
                         const int32_t* col, const int32_t* row0,
                         const int32_t* len, const uint8_t* committed,
                         const uint8_t* get_ok, const uint8_t* found,
                         const int32_t* value, const int32_t* vsn,
                         uint8_t* out_ok, uint8_t* out_gok,
                         uint8_t* out_fnd, int32_t* out_val,
                         int32_t* out_vsn) {
  if (!col || !row0 || !len || !committed || !get_ok || !found ||
      !value || !vsn || !out_ok || !out_gok || !out_fnd || !out_val ||
      !out_vsn) {
    return -1;
  }
  int64_t off = 0;
  for (int64_t i = 0; i < n_ent; i++) {
    const int32_t c = col[i];
    const int32_t r0 = row0[i];
    const int32_t n = len[i];
    if (c < 0 || c >= e || n < 0 || r0 < 0 || r0 + n > k) {
      return -1;
    }
    for (int32_t j = 0; j < n; j++, off++) {
      const int64_t p = static_cast<int64_t>(r0 + j) * e + c;
      out_ok[off] = committed[p];
      out_gok[off] = get_ok[p];
      out_fnd[off] = found[p];
      out_val[off] = value[p];
      out_vsn[2 * off] = vsn[2 * p];
      out_vsn[2 * off + 1] = vsn[2 * p + 1];
    }
  }
  return 0;
}

}  // extern "C"
