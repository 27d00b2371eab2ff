// R1: a joint-consensus reconfig step as ONE CUDA kernel for Hopper
// (sm_90a).
//
// What it replaces.  K1's redesign for the reconfig path: a
// reconfig_step ran K1 (the quorum predicate, replacing the TPU kernel
// quorum_met_epallas, riak_ensemble_tpu/ops/pallas_quorum.py:172) twice,
// once per commit gate, among some 60 small Torch ops — XLA's fusions of
// the reference's reconfig_propose, reconfig_transition and
// reconfig_step (riak_ensemble_tpu/ops/engine.py:1262-1384).  Here the
// gate, the install and the collapse of a row run in one thread, and a
// step is one launch.
//
// Semantics are the plain twins' (ops/engine.py _reconfig_gate,
// reconfig_propose_plain, reconfig_transition_plain), bit for bit.  Per row e, one thread:
// - gate: heard = up & member (member: in any view); the leader's epoch
//   (0 when leader is outside [0, M), the masked sum of the torch body);
//   ack = heard at that epoch, nack = heard & ~ack; commit_ok = K1's
//   predicate (quorum_common.cuh's resolve_view) MET & leader >= 0;
// - propose (propose[e]; `propose` null: none): install where commit_ok,
//   the new view is non-empty, the views list's last slot is free and
//   vsn > pend_vsn (signed; `vsn` null: pend_vsn + 1, wrapping as int32);
//   views = [new | views], view_vsn + 1, pend_vsn = vsn, fact_seq + 1 on
//   the heard replicas;
// - transition (run[e]; `run` null: !propose[e]): on the row as the
//   install left it (its gate evaluated again after an install), a joint
//   row whose gate holds keeps its head view only, view_vsn + 1,
//   commit_vsn = pend_vsn, fact_seq + 1 on the heard replicas.
// reconfig_step passes `run` and `vsn` null; reconfig_propose passes
// `run` as zeros; reconfig_transition passes `propose` null.  Every plane
// is stepped IN PLACE, as the torch path's _stepped copied it back.
//
// What bounds it on this card.  At 10,000 x 5, V = 2 a step must read
// ~300 KB (views, epochs, up, the proposal) and write ~90 KB: ~0.1 us at
// 3.35 TB/s, far under one launch, so R1 is launch-bound, as K1 was — but
// a step is now one launch where it was two K1 launches and ~60 ops.
//
// Contract (the Python wrapper checks it and raises; the entry point
// refuses it again): 1 <= M <= 128 (4-word peer masks; one word, its own
// instantiation, where M <= 32), 1 <= V <= 8.

#include <cuda_runtime.h>
#include <stdint.h>

#include "quorum_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWords = 4;  // peer masks: M <= 128
constexpr int kMaxViews = 8;

struct RParams {
  uint8_t* view_mask;    // [E, V, M]
  int32_t* view_vsn;     // [E]
  int32_t* pend_vsn;     // [E]
  int32_t* commit_vsn;   // [E]
  int32_t* fact_seq;     // [E, M]
  const int32_t* epoch;  // [E, M]
  const int32_t* leader;     // [E]
  const uint8_t* up;         // [E, M]
  const uint8_t* propose;    // [E] or null: no row proposes
  const uint8_t* new_view;   // [E, M] (with propose)
  const int32_t* vsn;        // [E] or null: pend_vsn + 1
  const uint8_t* run;        // [E] or null: !propose
  uint8_t* installed;        // [E]
  uint8_t* collapsed;        // [E]
  int e, m, v;
};

template <int kW>
struct Row {
  uint32_t views[kMaxViews][kW];
};

template <int kW>
__device__ __forceinline__ bool any_bits(const uint32_t (&w)[kW]) {
  uint32_t x = 0;
#pragma unroll
  for (int k = 0; k < kW; ++k) x |= w[k];
  return x != 0;
}

// The try_commit gate on the row's current views: the heard members into
// `heard`, and whether the acks at the leader's epoch reach a quorum in
// every view with a leader in place.  Views are indexed by unrolled
// counters only, so the row stays in registers.
template <int kW>
__device__ __forceinline__ bool gate(const Row<kW>& row, int v,
                                     const uint32_t (&up)[kW],
                                     const uint32_t (&at_lead)[kW],
                                     bool has_leader,
                                     uint32_t (&heard)[kW]) {
  uint32_t ack[kW], nack[kW];
#pragma unroll
  for (int w = 0; w < kW; ++w) {
    uint32_t member = 0;
#pragma unroll
    for (int j = 0; j < kMaxViews; ++j)
      if (j < v) member |= row.views[j][w];
    heard[w] = up[w] & member;
    ack[w] = heard[w] & at_lead[w];
    nack[w] = heard[w] & ~ack[w];
  }
  int8_t res = 1;
  bool decided = false;  // the first unmet view decides the row
#pragma unroll
  for (int j = 0; j < kMaxViews; ++j) {
    int members = 0, n_ack = 0, n_nack = 0;
#pragma unroll
    for (int w = 0; w < kW; ++w) {
      members += __popc(row.views[j][w]);
      n_ack += __popc(row.views[j][w] & ack[w]);
      n_nack += __popc(row.views[j][w] & nack[w]);
    }
    if (j < v && !decided)
      decided = resolve_view(n_ack, n_nack, members, members / 2 + 1, &res);
  }
  return res == 1 && has_leader;
}

// fact_seq + 1 (wrapping as int32) on the heard replicas of the row.
template <int kW>
__device__ __forceinline__ void bump(int32_t* fact, int m,
                                     const uint32_t (&heard)[kW]) {
#pragma unroll
  for (int w = 0; w < kW; ++w)
    for (uint32_t bits = heard[w]; bits; bits &= bits - 1) {
      const int r = w * 32 + __ffs(bits) - 1;
      if (r < m) fact[r] = (int32_t)((uint32_t)fact[r] + 1u);
    }
}

// A row's mask of kW words from M bytes.
template <int kW>
__device__ __forceinline__ void load_mask(const uint8_t* b, int m,
                                          uint32_t (&out)[kW]) {
#pragma unroll
  for (int w = 0; w < kW; ++w) {
    const int lo = w * 32;
    const int hi = min(m, lo + 32);
    uint32_t x = 0;
    for (int r = lo; r < hi; ++r) x |= (uint32_t)(b[r] != 0) << (r - lo);
    out[w] = x;
  }
}

template <int kW>
__global__ void __launch_bounds__(kThreads)
    reconfig_step_kernel(const RParams p) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= p.e) return;
  const int M = p.m, V = p.v;
  uint8_t* vm = p.view_mask + (size_t)e * V * M;
  const int32_t* ep = p.epoch + (size_t)e * M;
  const int leader = p.leader[e];
  const int32_t lead_epoch = leader >= 0 && leader < M ? ep[leader] : 0;

  Row<kW> row;
  uint32_t up[kW], at_lead[kW];
  load_mask(p.up + (size_t)e * M, M, up);
  // the views a peer at a time, views by an unrolled counter innermost
#pragma unroll
  for (int w = 0; w < kW; ++w) {
    uint32_t x[kMaxViews] = {};
    const int lo = w * 32;
    const int hi = min(M, lo + 32);
    for (int r = lo; r < hi; ++r) {
#pragma unroll
      for (int j = 0; j < kMaxViews; ++j)
        if (j < V) x[j] |= (uint32_t)(vm[(size_t)j * M + r] != 0) << (r - lo);
    }
#pragma unroll
    for (int j = 0; j < kMaxViews; ++j) row.views[j][w] = x[j];
  }
#pragma unroll
  for (int w = 0; w < kW; ++w) {
    const int lo = w * 32;
    const int hi = min(M, lo + 32);
    uint32_t x = 0;
    for (int r = lo; r < hi; ++r) x |= (uint32_t)(ep[r] == lead_epoch) << (r - lo);
    at_lead[w] = x;
  }

  const bool prop = p.propose != nullptr && p.propose[e] != 0;
  const bool run = p.run != nullptr ? p.run[e] != 0 : !prop;
  int32_t view_vsn = p.view_vsn[e];
  int32_t pend = p.pend_vsn[e];
  int32_t* fact = p.fact_seq + (size_t)e * M;
  bool installed = false, collapsed = false;
  uint32_t heard[kW] = {};
  bool commit_ok = false;
  if (prop || run) commit_ok = gate(row, V, up, at_lead, leader >= 0, heard);

  if (prop) {
    const int32_t vsn =
        p.vsn != nullptr ? p.vsn[e] : (int32_t)((uint32_t)pend + 1u);
    uint32_t nv[kW];
    load_mask(p.new_view + (size_t)e * M, M, nv);
    bool tail_used = false;
#pragma unroll
    for (int j = 0; j < kMaxViews; ++j)
      if (j == V - 1) tail_used = any_bits(row.views[j]);
    installed = commit_ok && any_bits(nv) && !tail_used && vsn > pend;
    if (installed) {
#pragma unroll
      for (int j = kMaxViews - 1; j > 0; --j)
        if (j < V) {
#pragma unroll
          for (int w = 0; w < kW; ++w)
            row.views[j][w] = row.views[j - 1][w];
        }
#pragma unroll
      for (int w = 0; w < kW; ++w) row.views[0][w] = nv[w];
      view_vsn = (int32_t)((uint32_t)view_vsn + 1u);
      pend = vsn;
      bump(fact, M, heard);
      p.pend_vsn[e] = pend;
      // the transition reads the row as the install left it
      if (run) commit_ok = gate(row, V, up, at_lead, leader >= 0, heard);
    }
  }
  if (run) {
    bool joint = false;
#pragma unroll
    for (int j = 1; j < kMaxViews; ++j)
      if (j < V) joint |= any_bits(row.views[j]);
    collapsed = joint && commit_ok;
    if (collapsed) {
#pragma unroll
      for (int j = 1; j < kMaxViews; ++j)
#pragma unroll
        for (int w = 0; w < kW; ++w) row.views[j][w] = 0;
      view_vsn = (int32_t)((uint32_t)view_vsn + 1u);
      p.commit_vsn[e] = pend;
      bump(fact, M, heard);
    }
  }
  if (installed || collapsed) {
    // a view's bytes from its mask, views and words by unrolled counters
#pragma unroll
    for (int w = 0; w < kW; ++w) {
      const int lo = w * 32;
      const int hi = min(M, lo + 32);
      for (int r = lo; r < hi; ++r) {
#pragma unroll
        for (int j = 0; j < kMaxViews; ++j)
          if (j < V) vm[(size_t)j * M + r] = (row.views[j][w] >> (r - lo)) & 1u;
      }
    }
    p.view_vsn[e] = view_vsn;
  }
  p.installed[e] = installed;
  p.collapsed[e] = collapsed;
}

}  // namespace

// Plain C entry point (bound with ctypes): `ptrs` holds the 14 device
// pointers in RParams order (propose, new_view, vsn and run may be null),
// `dims` E, M, V.  Launches on `stream` and returns cudaGetLastError() as
// an int (0 = launched); never synchronises or allocates.
extern "C" int retpu_reconfig_step(const uint64_t* ptrs, const int* dims,
                                   void* stream) {
  RParams p;
  p.view_mask = (uint8_t*)ptrs[0];
  p.view_vsn = (int32_t*)ptrs[1];
  p.pend_vsn = (int32_t*)ptrs[2];
  p.commit_vsn = (int32_t*)ptrs[3];
  p.fact_seq = (int32_t*)ptrs[4];
  p.epoch = (const int32_t*)ptrs[5];
  p.leader = (const int32_t*)ptrs[6];
  p.up = (const uint8_t*)ptrs[7];
  p.propose = (const uint8_t*)ptrs[8];
  p.new_view = (const uint8_t*)ptrs[9];
  p.vsn = (const int32_t*)ptrs[10];
  p.run = (const uint8_t*)ptrs[11];
  p.installed = (uint8_t*)ptrs[12];
  p.collapsed = (uint8_t*)ptrs[13];
  p.e = dims[0];
  p.m = dims[1];
  p.v = dims[2];
  if (p.e <= 0) return 0;
  if (p.m < 1 || p.m > kWords * 32 || p.v < 1 || p.v > kMaxViews ||
      (p.propose != nullptr && p.new_view == nullptr))
    return (int)cudaErrorInvalidValue;
  const int blocks = (p.e + kThreads - 1) / kThreads;
  // one 32-bit word a mask where the peers fit it (the common case), four
  // up to 128 peers
  if (p.m <= 32)
    reconfig_step_kernel<1><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(p);
  else
    reconfig_step_kernel<kWords>
        <<<blocks, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
