// F1: the engine's whole flush step as ONE CUDA kernel for Hopper (sm_90a).
//
// What it replaces.  In the JAX package XLA fuses the service's launch,
// _full_step_body (riak_ensemble_tpu/ops/engine.py:1386): the election
// (elect_step, :534-578), the round context (_kv_context), the K-round
// lax.scan (kv_step_scan, :945-979) over the K/V round (_kv_round,
// :629-864) and the follower epoch adoption (_adopt_epochs), with the
// quorum predicate (the TPU kernel quorum_met_epallas,
// riak_ensemble_tpu/ops/pallas_quorum.py:172, K1 in this package) inside.
// Here that is one launch per flush; the predicate is a device function
// (quorum_regs, over quorum_common.cuh's resolve_view) on 32-bit peer masks
// with the views in registers.
//
// Semantics are full_step_plain's, bit for bit: every state plane is read
// and updated in place, and the stacked result planes [K, E] (tree_corrupt
// [K, E, M]) are written in the layout KvResult holds.  The algorithm is
// not the plain version's round for round (tests/test_torch_f1_design.py
// holds a numpy transcription of it against the plain versions and the
// JAX package):
//
// - Rounds fall into three classes.  A NOOP round (kind not 1-4) and a
//   round with an invalid slot have results that are constants of the
//   ballot: an invalid slot's integrity verdict reaches no output (each
//   use is masked by the slot check or by obj_found, false there).  Their
//   lanes write those results in parallel; only the LIVE rounds run in
//   order.  A block with no live round stages and writes back nothing but
//   its ballot.
// - Integrity verdicts, not per-round re-verification.  Inside a launch
//   only the kernel's own writes change an ensemble's objects and tree, and
//   each write sets an object and its leaf together and (in the plain
//   version) refolds the slot's path.  So a replica's verdict at a slot is
//   exact from one state byte per upper node, BAD (the stored node differs
//   from the fold of its stored children) and DIRTY (a write lies under
//   it), and one per slot, BAD (the object's hash differs from its leaf)
//   and DIRTY (written).  Every warp sets the verdicts of every heard
//   replica once, at staging (a replica not heard reaches no output).  A
//   write marks its slot and path DIRTY and clears BAD; the written leaves
//   are hashed once, at the end.  (Verdicts on first touch, in the round
//   loop, measured slower at K = 64 and no faster at K = 1: PERF.md.)
//   A fold is one quad of lanes (lane = hash lane, each summing its lane
//   of the 16 children), so a warp folds eight parents a step.
// - Refold once, at the end: the DIRTY nodes, bottom-up, from their final
//   children — what the plain version's last refold of each left there.
//   Nodes off every written path keep their bits, corrupt ones included.
// - No block barrier in the round loop: a round is scalar logic on warp 0
//   (lane = replica) over shared memory.  Warp 0 holds 32 rounds' op
//   fields in registers (lane = round), broadcast by shuffles, and loads
//   the next 32 while it runs these; the first 32 load with the staging.
//   A round's results go to its own lane's registers and the 32 rounds'
//   are stored together, so no global access is on the rounds' chain.
// - Write-back of only the replicas that wrote, with TMA bulk stores.
//
// What bounds it on this card.  At 10,000 x 5 x 128, K = 64 the state is
// 187.1 MB, but a launch must move only ~250 MB: the heard replicas of the
// rows with a live round read, the ~30 % of replicas that change written,
// the ballot, op and result planes (cuda_engine.design_bytes) — ~0.075 ms
// at 3.35 TB/s.  The design's hashing (a fold per upper node and a leaf
// hash per slot of each heard replica, once; the refolds and leaf hashes
// of what was written) is ~0.05 ms at the int32 rate.  Neither sets the
// time: a live round is a chain of ~15 dependent warp-wide steps on warp 0
// (shared-memory loads, ballots, three max-reductions, the quorum
// predicate, the decision), so an
// ensemble takes its live rounds x that latency, plus staging, verdicts,
// refold and write-back.  At full width that runs in waves of resident
// blocks, and shared memory (19.3 KB a block) caps them at 11 per SM; the
// entry point picks the warps per block from the occupancy query (one at
// full width, eight at A = 256).  On an H100 80GB HBM3 at 700 W a launch
// takes ~0.39 ms full width; the bytes bound is ~19 % of that (PERF.md).
//
// Wide mode (_full_step_wide_body, riak_ensemble_tpu/ops/engine.py:1421, and
// _full_step_wide_sliced_body, :1523): dims[kW] = W > 1 lanes a round, the
// op and result planes [G, C, W] (tree_corrupt [G, C, M]), G = dims[kK].
// The reference's wide round is data-parallel over its lanes, and so is
// this: the valid slots of a group are distinct (kv_step_scan_wide's
// precondition) and a lane verifies against the tree as it stood before
// the group (_kv_round's corruption caveat), so each live lane's reads,
// verdicts, max-reduces, quorum predicates and decision depend on no other
// lane.  A warp holds lpw = 32 / M segments of M threads (thread =
// replica; 6 lanes a warp at M = 5, one at M > 16), and every warp of the
// block runs: a group goes in passes of nwarps * lpw lanes, which decide
// at once with segment-masked reduces and ballots.  A committing lane's
// seq is the counter plus the group's commits up to and including it (the
// reference's cumsum): a ballot and a popcount in the warp, the warps
// before it through shared memory (one block barrier a pass).  The lanes then write their objects and slot state
// bytes (distinct slots) and OR DIRTY into their paths' node bytes —
// every lane under a node stores the same value — while BAD stays set
// until the group ends: then the group's tree_corrupt row (its lanes'
// corrupt replicas OR'd) is stored and, if a write crossed a BAD node,
// BAD is cleared where DIRTY, four bytes a word, behind a block barrier.
// Thread rr of a segment holds its lane's op fields at step rr of each
// batch of M steps (shuffled out as scalar F1 shuffles its 32 rounds'),
// and the next batch loads while one runs.  The warps per block come from
// the occupancy query by its own rule (choose_shape).  W = 1 is the scalar
// mode above, path for path.  On an H100 80GB HBM3 at 700 W a full-width
// wide launch (G = 1, W = 64) takes ~0.27 ms, 27 % of its bytes bound, and
// ~0.18 ms of that with one live lane a row: the staging, verdicts, refold
// and write-back of blocks that hold one row each set it now (PERF.md).

// Contract (the Python wrapper checks it and raises; the entry point
// refuses it again): 1 <= M <= 32, 1 <= V <= 8, the staged planes within
// the card's shared memory, 16-byte aligned contiguous planes.
//
// Sliced mode (_full_step_sliced_body, riak_ensemble_tpu/ops/engine.py:1481):
// with an `active_idx [A]` the grid is A blocks and block b steps state row
// active_idx[b] IN PLACE — the same staging and rounds as above — reading
// `elect`/`cand` at [b] and the [K, A] op planes at column b, and writing
// every result at column b.  Idle rows are not touched: no epoch adoption,
// no quorum_ok.  No state plane is gathered into or scattered out of a
// copy.  The wrapper checks that the real indices ascend, are distinct and
// lie below E; the padding entries (index E) follow them.  The reference
// steps a pad as a copy of row E - 1 taken before the step, with NOOP
// rounds and no election, so a pad block only writes results: won = 0,
// quorum_ok = that copy's epoch check, everything else 0.  It reads row
// E - 1's view mask and up mask, which no block writes, and its epoch and
// leader from `pad_ballot` — a copy made before the launch — when row E - 1
// is itself active (its block rewrites them); otherwise from the state.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "quorum_common.cuh"
#include "tree_hash.cuh"

namespace {

constexpr int kMaxPeers = 32;
constexpr int kMaxViews = 8;
constexpr int kMaxLevels = kTrieLevels;  // shared memory caps S lower
constexpr int kMaxWarps = 8;

// per (replica, upper node) and (replica, slot) state bits
constexpr uint8_t kBad = 1, kDirty = 2;

// op kinds (ops/engine.py OP_*) and RMW fun codes (funref.RMW_*)
constexpr int kOpGet = 1, kOpPut = 2, kOpCas = 3, kOpRmw = 4;
constexpr int kRmwAdd = 0, kRmwSub = 1, kRmwMax = 2, kRmwMin = 3,
              kRmwBand = 5, kRmwBor = 6, kRmwBxor = 7, kRmwPia = 8;

// Pointer slots of the entry point's `ptrs` array (ops/cuda_engine.py
// builds it in this order).
enum Ptr {
  kEpoch, kFactSeq, kLeader, kObjSeqCtr, kViewMask, kObjEpoch, kObjSeq,
  kObjVal, kTreeLeaf, kTreeNode, kElect, kCand, kKind, kSlot, kVal,
  kLeaseOk, kExpEpoch, kExpSeq, kUp, kFoldConsts, kWon, kCommitted,
  kGetOk, kFound, kValue, kObjVsn, kQuorumOk, kTreeCorrupt, kActiveIdx,
  kPadBallot, kNumPtrs
};
enum Dim { kE, kM, kS, kU, kV, kK, kA, kW, kNumDims };

struct Params {
  int32_t* epoch;
  int32_t* fact_seq;
  int32_t* leader;
  int32_t* obj_seq_ctr;
  const uint8_t* view_mask;
  int32_t* obj_epoch;
  int32_t* obj_seq;
  int32_t* obj_val;
  uint32_t* tree_leaf;
  uint32_t* tree_node;
  const uint8_t* elect;  // null: no election (kv_step_scan)
  const int32_t* cand;
  const int32_t* kind;
  const int32_t* slot;
  const int32_t* val;
  const uint8_t* lease_ok;
  const int32_t* exp_epoch;  // null: zeros
  const int32_t* exp_seq;    // null: zeros
  const uint8_t* up;
  const uint32_t* fold_consts;  // 16 salts, then 16 odd multipliers
  uint8_t* won;                 // null with no election
  uint8_t* committed;
  uint8_t* get_ok;
  uint8_t* found;
  int32_t* value;
  int32_t* obj_vsn;
  uint8_t* quorum_ok;
  uint8_t* tree_corrupt;
  const int32_t* active_idx;  // null: every row, A = E
  const int32_t* pad_ballot;  // row E - 1's epoch [M] then leader; or null
  int e, m, s, u, v, k, a;
  int w;  // lanes per round: 1, or W of a wide launch (k = G groups)
};

// ---------------------------------------------------------------------------
// TMA 1-D bulk copies: staging on an mbarrier, write-back in a bulk group.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_s2g(void* dst, const void* src,
                                         uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
}

// Wait for the barrier's phase to complete.  A copy that never lands
// (a byte count that disagrees with the copies issued) traps after ~2^24
// polls instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t phase) {
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P1;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(phase)
        : "memory");
    if (done) return;
    if (polls > (1u << 24)) __trap();
  }
}

// Copy n 32-bit words, one per thread of the block (the object rows that
// TMA cannot take: M * S, or S, not a multiple of 4).
__device__ __forceinline__ void copy_words(uint32_t* dst, const uint32_t* src,
                                           int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

__device__ __forceinline__ int pad4(int n) { return (n + 3) & ~3; }
__device__ __forceinline__ int pad16(int n) { return (n + 15) & ~15; }
inline int pad4_host(int n) { return (n + 3) & ~3; }
inline int pad16_host(int n) { return (n + 15) & ~15; }

// One round's op fields, held by the lane of that round.
struct OpRow {
  int32_t kind, slot, val, exp_e, exp_s;
  bool lease;
};

// Flat round j of column `col` in the op and result planes: (g, col, w)
// of [K, C, W] with g = j / W in wide mode, (j, col) of [K, C] in scalar
// mode.  Rounds run in (g, w) order.
template <bool kWide>
__device__ __forceinline__ size_t op_index(const Params& p, int j, int C,
                                           int col) {
  if (!kWide) return (size_t)j * C + col;
  const int g = j / p.w;
  return ((size_t)g * C + col) * p.w + (j - g * p.w);
}

template <bool kWide>
__device__ __forceinline__ OpRow load_op(const Params& p, int j, int C,
                                         int col) {
  OpRow r{0, 0, 0, 0, 0, false};
  if (j < (kWide ? p.k * p.w : p.k)) {
    const size_t op = op_index<kWide>(p, j, C, col);
    r.kind = p.kind[op];
    r.slot = p.slot[op];
    r.val = p.val[op];
    r.lease = p.lease_ok[op];
    r.exp_e = p.exp_epoch ? p.exp_epoch[op] : 0;
    r.exp_s = p.exp_seq ? p.exp_seq[op] : 0;
  }
  return r;
}

__device__ __forceinline__ bool is_live(int kind, int slot, int s) {
  return kind >= kOpGet && kind <= kOpRmw && slot >= 0 && slot < s;
}

// Wide mode: the op fields of this segment's lane at step t (group t / P,
// lane (t mod P) * L + seg_lane), zeros past the plane or off a segment.
__device__ __forceinline__ OpRow wide_op(const Params& p, int t, int T, int P,
                                         int L, int seg_lane, bool seg, int C,
                                         int col) {
  OpRow r{0, 0, 0, 0, 0, false};
  if (seg && t < T) {
    const int g = t / P;
    const int w = (t - g * P) * L + seg_lane;
    if (w < p.w) {
      const size_t op = ((size_t)g * C + col) * p.w + w;
      r.kind = p.kind[op];
      r.slot = p.slot[op];
      r.val = p.val[op];
      r.lease = p.lease_ok[op];
      r.exp_e = p.exp_epoch ? p.exp_epoch[op] : 0;
      r.exp_s = p.exp_seq ? p.exp_seq[op] : 0;
    }
  }
  return r;
}

// quorum_met_bits (quorum_common.cuh) over views held in registers.
__device__ __forceinline__ int8_t quorum_regs(uint32_t valid, uint32_t nack,
                                              const uint32_t (&views)[kMaxViews],
                                              int v) {
  int8_t res = 1;
#pragma unroll
  for (int j = 0; j < kMaxViews; ++j) {
    if (j >= v) break;
    const int members = __popc(views[j]);
    if (resolve_view(__popc(views[j] & valid), __popc(views[j] & nack),
                     members, members / 2 + 1, &res))
      break;
  }
  return res;
}

// A live round's decision, from the newest object among its hash-valid
// replicas (_latest_among: obj_found, rd_*) and their mask `okmask`; the
// same in every thread that runs the round.
struct Decision {
  bool commit, get_ok, found, served, rmw_commit, plain_read;
  int32_t wval, new_rmw;
};

__device__ __forceinline__ Decision decide(
    int kind, int32_t val, int32_t exp_e, int32_t exp_s, bool lease,
    bool obj_found, int32_t rd_epoch, int32_t rd_seq, int32_t rd_val,
    uint32_t okmask, uint32_t heard, const uint32_t (&views)[kMaxViews],
    int v, int n_member, bool epoch_ok, bool leader_up, int32_t lead_epoch) {
  const bool is_put = kind == kOpPut, is_get = kind == kOpGet;
  const bool is_cas = kind == kOpCas, is_rmw = kind == kOpRmw;
  const bool found = obj_found && rd_val != 0;
  const bool all_ok = __popc(okmask) == n_member;

  // The notfound quorum of the hash-valid answers: read only where no
  // object was found, by a read, a CAS or an RMW.
  const bool nf_quorum = !obj_found && !is_put &&
                         quorum_regs(okmask, heard & ~okmask, views, v) == 1;
  const bool get_gate = is_get && leader_up && (lease || epoch_ok);
  const bool stale = obj_found && rd_epoch != lead_epoch;
  const bool rewrite = get_gate && stale && epoch_ok;
  const bool nf = get_gate && !obj_found;
  const bool nf_write = nf && !all_ok && epoch_ok && nf_quorum;
  const bool get_ok = (get_gate && obj_found && (!stale || rewrite)) ||
                      (nf && (all_ok || nf_write));

  const bool put_commit = is_put && epoch_ok;
  const bool exp_absent = exp_e == 0 && exp_s == 0;
  const bool vsn_match =
      (obj_found && rd_epoch == exp_e && rd_seq == exp_s) ||
      (exp_absent && obj_found && rd_val == 0) ||
      (exp_absent && !obj_found && nf_quorum);
  const bool cas_commit = is_cas && epoch_ok && vsn_match;

  // Device RMW: fn(cur, operand); + and - wrap mod 2^32 as in torch;
  // RMW_SET, RMW_PIA and an unknown code commit the operand.
  const int fn = exp_e;
  const int32_t cv = rd_val;
  const int32_t new_rmw =
      fn == kRmwAdd    ? (int32_t)((uint32_t)cv + (uint32_t)val)
      : fn == kRmwSub  ? (int32_t)((uint32_t)cv - (uint32_t)val)
      : fn == kRmwMax  ? (cv > val ? cv : val)
      : fn == kRmwMin  ? (cv < val ? cv : val)
      : fn == kRmwBand ? (cv & val)
      : fn == kRmwBor  ? (cv | val)
      : fn == kRmwBxor ? (cv ^ val)
                       : val;
  const bool rmw_absent =
      (obj_found && rd_val == 0) || (!obj_found && nf_quorum);
  const bool rmw_known = obj_found || nf_quorum;
  const bool rmw_commit =
      is_rmw && epoch_ok && (fn == kRmwPia ? rmw_absent : rmw_known);

  Decision d;
  d.commit = put_commit || cas_commit || rewrite || nf_write || rmw_commit;
  d.wval = (is_put || is_cas) ? val
           : is_rmw           ? new_rmw
           : rewrite          ? rd_val
                              : 0;
  d.get_ok = get_ok;
  d.found = found;
  d.served = get_ok && obj_found;
  d.rmw_commit = rmw_commit;
  d.new_rmw = new_rmw;
  // a plain read repairs the divergent replicas
  d.plain_read = get_ok && obj_found && !rewrite;
  return d;
}

// The round context's epoch check on warp 0 (lane = replica): the leader's
// epoch (0 with no leader), whether it is up, and whether the heard members
// at that epoch reach a quorum in every view.
__device__ __forceinline__ bool epoch_check(int32_t epoch_m, int leader,
                                            uint32_t heard, bool in, int m,
                                            const uint32_t (&views)[kMaxViews],
                                            int v, int32_t* lead_epoch,
                                            bool* leader_up) {
  const bool leader_in = leader >= 0 && leader < m;
  int32_t le = __shfl_sync(kFull, epoch_m, leader_in ? leader : 0);
  if (!leader_in) le = 0;
  const bool lu = leader_in && ((heard >> leader) & 1u);
  const uint32_t ack = heard & __ballot_sync(kFull, in && epoch_m == le);
  *lead_epoch = le;
  *leader_up = lu;
  return lu && quorum_regs(ack, heard & ~ack, views, v) == 1;
}

// Warp 0 (lane = replica): row `row`'s views into registers, their union,
// and the heard members.  Every byte loads before the first ballot.
__device__ __forceinline__ uint32_t load_views(const Params& p, int row,
                                               int lane, bool in,
                                               uint32_t (&views)[kMaxViews],
                                               uint32_t* heard) {
  bool member[kMaxViews];
#pragma unroll
  for (int j = 0; j < kMaxViews; ++j)
    member[j] =
        in && j < p.v && p.view_mask[((size_t)row * p.v + j) * p.m + lane];
  const bool up = in && p.up[(size_t)row * p.m + lane];
  uint32_t any = 0;
#pragma unroll
  for (int j = 0; j < kMaxViews; ++j) {
    views[j] = __ballot_sync(kFull, member[j]);
    any |= views[j];
  }
  *heard = __ballot_sync(kFull, up) & any;
  return any;
}

// What every warp of a wide block shares: the row's round context, which
// warp 0 works out before the first block barrier, and the per-pass and
// per-group tallies.  Declared here, it exists only in the kernel that
// calls it (the wide instantiation).
struct WideShared {
  uint32_t views[kMaxViews];
  int32_t lead_epoch, ctr;
  int n_member, epoch_ok, leader_up;
  uint32_t commits[2][kMaxWarps];  // a pass's commits by warp, by parity
  uint32_t corrupt[2];             // a group's corrupt replicas, by parity
  int heal[2];                     // a write of the group crossed a BAD node
};

__device__ __forceinline__ WideShared& wide_shared() {
  __shared__ WideShared ws;
  return ws;
}

// The replicas flagged in `bits` (a ballot over a warp of `lpw` segments
// of `m` lanes, lane = replica), OR'd over the segments.
__device__ __forceinline__ uint32_t fold_segments(uint32_t bits, int m,
                                                  int lpw, uint32_t low) {
  uint32_t out = 0;
  for (int q = 0; q < lpw; ++q) out |= (bits >> (q * m)) & low;
  return out;
}

// ---------------------------------------------------------------------------

// One instantiation per mode: the scalar one (kWide false) compiles to the
// scalar algorithm alone, none of the wide mode's group bookkeeping.
template <bool kWide>
__global__ void __launch_bounds__(kMaxWarps * 32)
    engine_step_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint32_t s_consts[2 * kWidth];  // the fold's salts, multipliers
  __shared__ uint32_t s_heard;  // heard members of the row
  __shared__ uint32_t s_wrote;  // replicas that wrote in this launch
  __shared__ int s_stage;       // 1: a live round needs the planes
  __shared__ __align__(8) uint64_t s_bar;

  const int E = p.e, M = p.m, S = p.s, U = p.u, V = p.v, K = p.k;
  const int R = kWide ? K * p.w : K;  // flat rounds, (group, lane) order
  constexpr bool wide = kWide;
  const int C = p.a;  // columns of the op, election and result planes
  const int col = blockIdx.x;
  const int e = p.active_idx ? p.active_idx[col] : col;  // the state row
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int MS = M * S;
  const bool in = lane < M;
  uint32_t views[kMaxViews] = {};
  // Wide mode's lane map: lpw segments of M threads a warp, segment q
  // taking lane `seg_lane` of each pass of L = nwarps * lpw lanes, thread rr
  // of it replica rr; the threads past the last segment (q == lpw) idle.
  const int lpw = 32 / M;
  const int q = lane / M;
  const int rr = lane - q * M;
  const bool seg = q < lpw;
  const int shift = q * M;
  const uint32_t low = M == 32 ? kFull : (1u << M) - 1u;
  const uint32_t segmask = seg ? low << shift : kFull << shift;
  const int L = nwarps * lpw;
  const int P = kWide ? (p.w + L - 1) / L : 0;  // passes a group
  const int T = K * P;
  const int seg_lane = warp * lpw + q;

  if (e >= E) {
    // A pad column: the epoch check of row E - 1 as it stood before the
    // launch, then NOOP results for every round.
    if (warp != 0) return;
    const int row = E - 1;
    uint32_t heard;
    load_views(p, row, lane, in, views, &heard);
    const int32_t* ballot_epoch =
        p.pad_ballot ? p.pad_ballot : p.epoch + (size_t)row * M;
    const int32_t epoch_m = in ? ballot_epoch[lane] : 0;
    const int leader = p.pad_ballot ? p.pad_ballot[M] : p.leader[row];
    int32_t lead_epoch;
    bool leader_up;
    const bool epoch_ok = epoch_check(epoch_m, leader, heard, in, M, views,
                                      V, &lead_epoch, &leader_up);
    if (lane == 0 && p.won != nullptr) p.won[col] = 0;
    for (int j = lane; j < R; j += 32) {
      const size_t op = op_index<kWide>(p, j, C, col);
      p.committed[op] = 0;
      p.get_ok[op] = 0;
      p.found[op] = 0;
      p.value[op] = 0;
      p.obj_vsn[op * 2] = 0;
      p.obj_vsn[op * 2 + 1] = 0;
      p.quorum_ok[op] = epoch_ok;
    }
    for (int i = lane; i < K * M; i += 32)
      p.tree_corrupt[((size_t)(i / M) * C + col) * M + i % M] = 0;
    return;
  }

  int32_t* s_oe = reinterpret_cast<int32_t*>(smem);
  int32_t* s_os = s_oe + pad4(MS);
  int32_t* s_ov = s_os + pad4(MS);
  uint32_t* s_leaf = reinterpret_cast<uint32_t*>(s_ov + pad4(MS));
  uint32_t* s_node = s_leaf + MS * 4;
  uint8_t* s_nst = reinterpret_cast<uint8_t*>(s_node + M * U * 4);
  uint8_t* s_sst = s_nst + pad16(M * U);  // [M, S]: a slot's leaf state

  const size_t obj_base = (size_t)e * MS;
  const size_t leaf_base = obj_base * 4;
  const size_t node_base = (size_t)e * M * U * 4;
  // TMA needs 16-byte aligned rows: the ensemble's object rows are when
  // M * S is a multiple of 4, a replica's when S is; tree rows always are.
  const bool obj_tma = (MS & 3) == 0;
  if (threadIdx.x < 2 * kWidth) s_consts[threadIdx.x] = p.fold_consts[threadIdx.x];

  // Warp 0, lane = round: the first 32 rounds' op fields, and whether any
  // round is live; lane = replica: the ballot, the election and the round
  // context.  Lane 0 starts the staging as soon as it is known to be
  // needed, and the election runs while it lands.
  int32_t epoch_m = 0, fact_m = 0, leader = 0, ctr = 0, lead_epoch = 0;
  uint32_t heard = 0, views_any = 0;
  bool leader_up = false, epoch_ok = false;
  int n_member = 0;
  OpRow cur{0, 0, 0, 0, 0, false};
  if (warp == 0) {
    cur = load_op<kWide>(p, lane, C, col);
    bool live = is_live(cur.kind, cur.slot, S);
    if constexpr (kWide) {
      // the other flat rounds' kinds and slots, four loads in flight a lane
#pragma unroll 4
      for (int j = lane + 32; j < R; j += 32) {
        const size_t op = op_index<kWide>(p, j, C, col);
        live |= is_live(p.kind[op], p.slot[op], S);
      }
    } else {
      for (int j = lane + 32; j < R; j += 32) {
        const size_t op = op_index<kWide>(p, j, C, col);
        live |= is_live(p.kind[op], p.slot[op], S);
      }
    }
    views_any = load_views(p, e, lane, in, views, &heard);
    if (in) {
      epoch_m = p.epoch[(size_t)e * M + lane];
      fact_m = p.fact_seq[(size_t)e * M + lane];
    }
    leader = p.leader[e];
    ctr = p.obj_seq_ctr[e];
    const bool stage = __any_sync(kFull, live);
    if (lane == 0) {
      s_stage = stage;
      s_heard = heard;
      s_wrote = 0;
      if (stage) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                         smem_u32(&s_bar))
                     : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        const uint32_t obj_b = obj_tma ? (uint32_t)MS * 4 : 0u;
        const uint32_t leaf_b = (uint32_t)MS * 16;
        const uint32_t node_b = (uint32_t)M * U * 16;
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                smem_u32(&s_bar)),
            "r"(3 * obj_b + leaf_b + node_b)
            : "memory");
        if (obj_tma) {
          bulk_g2s(s_oe, p.obj_epoch + obj_base, obj_b, &s_bar);
          bulk_g2s(s_os, p.obj_seq + obj_base, obj_b, &s_bar);
          bulk_g2s(s_ov, p.obj_val + obj_base, obj_b, &s_bar);
        }
        bulk_g2s(s_leaf, p.tree_leaf + leaf_base, leaf_b, &s_bar);
        bulk_g2s(s_node, p.tree_node + node_base, node_b, &s_bar);
      }
    }
    const bool heard_m = (heard >> lane) & 1u;

    if (p.elect != nullptr) {
      // Phase 1: NextEpoch = max(heard epochs, -1) + 1, every heard member
      // acks; phase 2 on quorum: members adopt it, counters reset.  The
      // candidate must itself be an up member.
      const int next_epoch =
          __reduce_max_sync(kFull, heard_m ? epoch_m : -1) + 1;
      const int cand = p.cand[col];
      const bool cand_heard = cand >= 0 && cand < M && ((heard >> cand) & 1u);
      const bool won = p.elect[col] && cand_heard &&
                       quorum_regs(heard, 0u, views, V) == 1;
      if (won) {
        if (heard_m) {
          epoch_m = next_epoch;
          fact_m = 0;
        }
        leader = cand;
        ctr = 0;
      }
      if (lane == 0) p.won[col] = won;
    }

    // The round context: the epoch-check quorum shared by every round.
    epoch_ok = epoch_check(epoch_m, leader, heard, in, M, views, V,
                           &lead_epoch, &leader_up);
    n_member = __popc(views_any);
    if constexpr (kWide) {
      WideShared& ws = wide_shared();
      if (lane == 0) {
#pragma unroll
        for (int j = 0; j < kMaxViews; ++j) ws.views[j] = views[j];
        ws.lead_epoch = lead_epoch;
        ws.ctr = ctr;
        ws.n_member = n_member;
        ws.epoch_ok = epoch_ok;
        ws.leader_up = leader_up;
        ws.corrupt[0] = ws.corrupt[1] = 0;
        ws.heal[0] = ws.heal[1] = 0;
      }
    }
  }
  // Wide mode: thread rr of a segment holds the op fields of its lane at
  // step rr of each batch of M steps; the first batch loads while the
  // staging lands.
  OpRow hold{0, 0, 0, 0, 0, false};
  if constexpr (kWide) hold = wide_op(p, rr, T, P, L, seg_lane, seg, C, col);
  __syncthreads();
  const bool stage = s_stage;
  const Levels lv = levels_of(S);
  const int quad = lane >> 2, li = lane & 3;

  if (stage) {
    if (!obj_tma) {
      copy_words((uint32_t*)s_oe, (const uint32_t*)p.obj_epoch + obj_base, MS);
      copy_words((uint32_t*)s_os, (const uint32_t*)p.obj_seq + obj_base, MS);
      copy_words((uint32_t*)s_ov, (const uint32_t*)p.obj_val + obj_base, MS);
    }
    for (int i = threadIdx.x; i < M * U; i += blockDim.x) s_nst[i] = 0;
    mbar_wait(&s_bar, 0);
    __syncthreads();
    // The verdicts of every heard replica: each slot's (its object's hash
    // against its leaf) by every thread; each upper node's by every warp,
    // eight a step (one a quad).
    const uint32_t hrd = s_heard;
    for (int i = threadIdx.x; i < MS; i += blockDim.x) {
      bool bad = false;
      if ((hrd >> (i / S)) & 1u) {
#pragma unroll
        for (int l = 0; l < 4; ++l)
          bad |= leaf_lane(s_oe[i], s_os[i], s_ov[i], l) != s_leaf[i * 4 + l];
      }
      s_sst[i] = bad ? kBad : 0;
    }
    for (int base = warp * 8; base < M * U; base += nwarps * 8) {
      const int i = base + quad;
      const int r = i / U, n = i - r * U;
      const bool mine = i < M * U && ((hrd >> r) & 1u);
      int pidx = 0, cn = 0;
      const uint32_t* child =
          children_of(lv, n, s_leaf + (size_t)r * S * 4,
                      s_node + (size_t)r * U * 4, S, &pidx, &cn);
      const uint32_t got =
          fold_quad(mine ? child : nullptr, cn, pidx, lane, s_consts);
      const uint32_t diff = __ballot_sync(
          kFull, mine && got != s_node[((size_t)r * U + n) * 4 + li]);
      if (mine && li == 0)
        s_nst[r * U + n] = ((diff >> (lane & ~3)) & 0xFu) ? kBad : 0;
    }
    __syncthreads();
  }

  if constexpr (kWide) {
    // Every warp: a group's lanes, decided from the state as it stood
    // before the group, in passes of L = nwarps * lpw lanes; one lane a
    // segment of M threads (thread = replica).  See the header.
    WideShared& ws = wide_shared();
    const uint32_t hrd = s_heard;
    uint32_t wv[kMaxViews];
#pragma unroll
    for (int j = 0; j < kMaxViews; ++j) wv[j] = ws.views[j];
    const int32_t le = ws.lead_epoch;
    const bool eok = ws.epoch_ok, lup = ws.leader_up;
    const int nmem = ws.n_member;
    uint32_t c = (uint32_t)ws.ctr;
    const bool heard_r = seg && ((hrd >> rr) & 1u);
    bool corrupt_r = false, heal = false, wrote_r = false;
    int par = 0;
    // the next batch loads while this one runs
    OpRow ahead = wide_op(p, M + rr, T, P, L, seg_lane, seg, C, col);
    // step t: pass t mod P of group g, batch step j
    for (int t = 0, g = 0, pg = 0, j = 0; t < T; ++t, ++j) {
      if (j == M) {
        hold = ahead;
        ahead = wide_op(p, t + M + rr, T, P, L, seg_lane, seg, C, col);
        j = 0;
      }
      const int src = seg ? shift + j : lane;
      OpRow cur;
      cur.kind = __shfl_sync(kFull, hold.kind, src);
      cur.slot = __shfl_sync(kFull, hold.slot, src);
      cur.val = __shfl_sync(kFull, hold.val, src);
      cur.exp_e = __shfl_sync(kFull, hold.exp_e, src);
      cur.exp_s = __shfl_sync(kFull, hold.exp_s, src);
      cur.lease = __shfl_sync(kFull, (int)hold.lease, src);
      const int w = pg * L + seg_lane;
      const bool have = seg && w < p.w;
      const bool live = have && is_live(cur.kind, cur.slot, S);
      // a NOOP lane's or an invalid slot's results: the ballot's alone
      bool r_commit = false, r_found = false;
      bool r_get = cur.kind == kOpGet && lup && (cur.lease || eok);
      int32_t r_value = 0, r_vsn0 = 0, r_vsn1 = 0;
      bool commit = false, do_write = false, path_bad = false;
      int32_t w_epoch = 0, w_seq = 0, w_val = 0;
      int path[kMaxLevels];
      int o = 0;
      if (__any_sync(kFull, live)) {
        {
          int idx = cur.slot;
#pragma unroll
          for (int l = 0; l < kMaxLevels; ++l) {
            idx /= kWidth;
            path[l] = lv.off[l] + idx;
          }
        }
        o = rr * S + cur.slot;
        const int32_t pe = live ? s_oe[o] : 0;
        const int32_t ps = live ? s_os[o] : 0;
        const int32_t pv = live ? s_ov[o] : 0;
        // A heard replica's verdicts at the slot, as they stood before
        // the group (a replica not heard reaches no output).
        bool leaf_ok = true;
        if (live && heard_r) {
          leaf_ok = !(s_sst[o] & kBad);
#pragma unroll
          for (int l = 0; l < kMaxLevels; ++l)
            if (l < lv.count)
              path_bad |= (s_nst[rr * U + path[l]] & kBad) != 0;
        }
        const bool ok_m = live && heard_r && leaf_ok && !path_bad;
        const uint32_t okmask = (__ballot_sync(kFull, ok_m) >> shift) & low;
        corrupt_r |= live && heard_r && (path_bad || !leaf_ok);

        // _latest_among: three max-reduces over the segment's replicas.
        const bool h = ok_m && ps > 0;
        const int emax = __reduce_max_sync(segmask, h ? pe : -1);
        const int smax =
            __reduce_max_sync(segmask, h && pe == emax ? ps : -1);
        const int vmax = __reduce_max_sync(
            segmask, h && pe == emax && ps == smax ? pv : INT32_MIN);
        const bool obj_found = smax > 0;
        const int32_t rd_epoch = emax > 0 ? emax : 0;
        const int32_t rd_seq = smax > 0 ? smax : 0;
        const int32_t rd_val = obj_found ? vmax : 0;
        const Decision d =
            decide(cur.kind, cur.val, cur.exp_e, cur.exp_s, cur.lease,
                   obj_found, rd_epoch, rd_seq, rd_val, okmask, hrd, wv, V,
                   nmem, eok, lup, le);
        const bool divergent = heard_r && (pe != rd_epoch || ps != rd_seq ||
                                           !leaf_ok || path_bad);
        commit = live && d.commit;
        do_write =
            live && ((d.commit && heard_r) || (d.plain_read && divergent));
        w_epoch = d.commit ? le : rd_epoch;
        w_seq = rd_seq;  // a commit's seq comes from the count below
        w_val = d.commit ? d.wval : rd_val;
        if (live) {
          r_commit = d.commit;
          r_get = d.get_ok;
          r_found = d.found && d.get_ok;
          r_value = d.rmw_commit ? d.new_rmw
                                 : (d.get_ok && d.found ? rd_val : 0);
          r_vsn0 = d.commit ? le : (d.served ? rd_epoch : 0);
          r_vsn1 = d.served ? rd_seq : 0;
        }
      }
      // A commit's seq: the counter plus the group's commits up to and
      // including its lane, in lane order (the reference's cumsum) — a
      // ballot and a popcount in the warp, the warps before it through
      // shared memory.
      const uint32_t cb = __ballot_sync(kFull, commit && rr == 0);
      uint32_t upto = __popc(cb & ((2u << shift) - 1u));
      uint32_t total = __popc(cb);
      if (lane == 0) ws.commits[par][warp] = total;
      __syncthreads();
      total = 0;
      for (int i = 0; i < nwarps; ++i) {
        const uint32_t n = ws.commits[par][i];
        upto += i < warp ? n : 0u;
        total += n;
      }
      par ^= 1;
      if (commit) {
        w_seq = (int32_t)(c + upto);
        r_vsn1 = w_seq;
      }
      c += total;
      // The lanes' slots are distinct: no other lane of the group reads
      // what this one writes.  A path node is marked DIRTY by every lane
      // under it with the same value; its BAD bit stays until the group
      // ends, for the group's lanes verify against the tree as it stood.
      if (do_write) {
        s_oe[o] = w_epoch;
        s_os[o] = w_seq;
        s_ov[o] = w_val;
        s_sst[o] = kDirty;  // its leaf is hashed at the end
#pragma unroll
        for (int l = 0; l < kMaxLevels; ++l)
          if (l < lv.count) s_nst[rr * U + path[l]] |= kDirty;
        wrote_r = true;
        heal |= path_bad;
      }
      if (have && rr == 0) {
        const size_t op = ((size_t)g * C + col) * p.w + w;
        p.committed[op] = r_commit;
        p.get_ok[op] = r_get;
        p.found[op] = r_found;
        p.value[op] = r_value;
        p.obj_vsn[op * 2] = r_vsn0;
        p.obj_vsn[op * 2 + 1] = r_vsn1;
        p.quorum_ok[op] = eok;
      }
      __syncwarp();
      if (++pg == P) {
        // The group ends: its tree_corrupt row (its lanes' corrupt
        // replicas OR'd), and the paths it wrote become trusted (BAD
        // cleared where DIRTY, four state bytes a word).
        uint32_t bits =
            fold_segments(__ballot_sync(kFull, corrupt_r), M, lpw, low);
        const int healed_w = __any_sync(kFull, heal);
        const int gp = g & 1;
        if (lane == 0) {
          if (bits) atomicOr(&ws.corrupt[gp], bits);
          if (healed_w) ws.heal[gp] = 1;
        }
        __syncthreads();
        bits = ws.corrupt[gp];
        const int healed = ws.heal[gp];
        if (threadIdx.x == 0) {  // the next group's tallies
          ws.corrupt[gp ^ 1] = 0;
          ws.heal[gp ^ 1] = 0;
        }
        if ((int)threadIdx.x < M)
          p.tree_corrupt[((size_t)g * C + col) * M + threadIdx.x] =
              (bits >> threadIdx.x) & 1u;
        if (healed) {  // block-uniform
          uint32_t* words = reinterpret_cast<uint32_t*>(s_nst);
          for (int i = threadIdx.x; i < (M * U + 3) / 4; i += blockDim.x) {
            const uint32_t x = words[i];
            words[i] = x & ~((x >> 1) & 0x01010101u);
          }
        }
        __syncthreads();
        corrupt_r = heal = false;
        pg = 0;
        ++g;
      }
    }
    const uint32_t wb =
        fold_segments(__ballot_sync(kFull, wrote_r), M, lpw, low);
    if (lane == 0 && wb) atomicOr(&s_wrote, wb);
    ctr = (int32_t)c;
  } else if (warp == 0 && K > 0) {
    // The scalar mode: warp 0 runs the rounds, 32 at a time.  Lane j holds
    // round base + j's op fields and, once it has run, its results, stored
    // together at the end of the 32.  This branch is compiled only with
    // kWide false, so its `wide` branches (a group walk) are dead code.
    // They stay because taking them out changes the compiler's schedule of
    // the scalar instantiation (the same 106 registers, other instructions
    // on an H100 build), which this mode keeps instruction for instruction.
    const bool heard_m = (heard >> lane) & 1u;
    uint32_t wrote = 0;
    int group = 0;             // the group the walk is in
    uint32_t group_bits = 0;   // its corrupt replicas so far
    bool heal_m = false;       // this replica wrote over a BAD node in it
    // Leave group `group` for group `to`: store its row and zero rows of
    // the groups skipped; a write's path becomes trusted (BAD cleared)
    // only now, for the wide round's lanes verify against the tree as it
    // stood before the round.
    auto leave_group = [&](int to) {
      for (int g = group; g < to; ++g)
        if (in)
          p.tree_corrupt[((size_t)g * C + col) * M + lane] =
              g == group ? (group_bits >> lane) & 1u : 0;
      if (heal_m)
        for (int n = 0; n < U; ++n)
          if (s_nst[lane * U + n] & kDirty) s_nst[lane * U + n] = kDirty;
      heal_m = false;
      group_bits = 0;
      group = to;
      __syncwarp();
    };
    for (int base = 0; base < R; base += 32) {
      const OpRow nxt = load_op<kWide>(p, base + 32 + lane, C, col);
      const bool have = base + lane < R;
      const bool live = have && is_live(cur.kind, cur.slot, S);
      // a NOOP round's or an invalid slot's results: the ballot's alone
      bool r_commit = false, r_found = false;
      bool r_get = cur.kind == kOpGet && leader_up && (cur.lease || epoch_ok);
      int32_t r_value = 0, r_vsn0 = 0, r_vsn1 = 0;
      uint32_t r_corrupt = 0;
      uint32_t todo = __ballot_sync(kFull, live);
      while (todo) {
        const int src = __ffs(todo) - 1;
        todo &= todo - 1;
        if (wide && (base + src) / p.w != group)
          leave_group((base + src) / p.w);
        const int kind = __shfl_sync(kFull, cur.kind, src);
        const int sc = __shfl_sync(kFull, cur.slot, src);
        const int32_t val = __shfl_sync(kFull, cur.val, src);
        const int32_t exp_e = __shfl_sync(kFull, cur.exp_e, src);
        const int32_t exp_s = __shfl_sync(kFull, cur.exp_s, src);
        const bool lease = __shfl_sync(kFull, (int)cur.lease, src);

        // the path's nodes, leafward -> root
        int path[kMaxLevels];
        {
          int idx = sc;
#pragma unroll
          for (int l = 0; l < kMaxLevels; ++l) {
            idx /= kWidth;
            path[l] = lv.off[l] + idx;
          }
        }
        const int o = lane * S + sc;
        const int32_t pe = in ? s_oe[o] : 0;
        const int32_t ps = in ? s_os[o] : 0;
        const int32_t pv = in ? s_ov[o] : 0;
        // A heard replica's verdicts at the slot (a replica not heard
        // reaches no output).
        bool leaf_ok = true, path_bad = false;
        if (heard_m) {
          leaf_ok = !(s_sst[o] & kBad);
#pragma unroll
          for (int l = 0; l < kMaxLevels; ++l)
            if (l < lv.count)
              path_bad |= (s_nst[lane * U + path[l]] & kBad) != 0;
        }
        const bool is_put = kind == kOpPut, is_get = kind == kOpGet;
        const bool is_cas = kind == kOpCas, is_rmw = kind == kOpRmw;
        const bool ok_m = heard_m && leaf_ok && !path_bad;
        const uint32_t okmask = __ballot_sync(kFull, ok_m);
        const bool corrupt_m = (path_bad || !leaf_ok) && heard_m;

        // Newest (epoch, seq) object among the hash-valid replicas
        // (_latest_among): three masked max-reduces over the peers.
        const bool h = ok_m && ps > 0;
        const int emax = __reduce_max_sync(kFull, h ? pe : -1);
        const int smax = __reduce_max_sync(kFull, h && pe == emax ? ps : -1);
        const int vmax = __reduce_max_sync(
            kFull, h && pe == emax && ps == smax ? pv : INT32_MIN);
        const bool obj_found = smax > 0;
        const int32_t rd_epoch = emax > 0 ? emax : 0;
        const int32_t rd_seq = smax > 0 ? smax : 0;
        const int32_t rd_val = obj_found ? vmax : 0;
        const bool found = obj_found && rd_val != 0;
        const bool all_ok = __popc(okmask) == n_member;

        // The notfound quorum of the hash-valid answers: read only where
        // no object was found, by a read, a CAS or an RMW.
        const bool nf_quorum =
            !obj_found && !is_put &&
            quorum_regs(okmask, heard & ~okmask, views, V) == 1;
        const bool get_gate = is_get && leader_up && (lease || epoch_ok);
        const bool stale = obj_found && rd_epoch != lead_epoch;
        const bool rewrite = get_gate && stale && epoch_ok;
        const bool nf = get_gate && !obj_found;
        const bool nf_write = nf && !all_ok && epoch_ok && nf_quorum;
        const bool get_ok = (get_gate && obj_found && (!stale || rewrite)) ||
                            (nf && (all_ok || nf_write));

        const bool put_commit = is_put && epoch_ok;
        const bool exp_absent = exp_e == 0 && exp_s == 0;
        const bool vsn_match =
            (obj_found && rd_epoch == exp_e && rd_seq == exp_s) ||
            (exp_absent && obj_found && rd_val == 0) ||
            (exp_absent && !obj_found && nf_quorum);
        const bool cas_commit = is_cas && epoch_ok && vsn_match;

        // Device RMW: fn(cur, operand); + and - wrap mod 2^32 as in torch;
        // RMW_SET, RMW_PIA and an unknown code commit the operand.
        const int fn = exp_e;
        const int32_t cv = rd_val;
        const int32_t new_rmw =
            fn == kRmwAdd   ? (int32_t)((uint32_t)cv + (uint32_t)val)
            : fn == kRmwSub ? (int32_t)((uint32_t)cv - (uint32_t)val)
            : fn == kRmwMax ? (cv > val ? cv : val)
            : fn == kRmwMin ? (cv < val ? cv : val)
            : fn == kRmwBand ? (cv & val)
            : fn == kRmwBor  ? (cv | val)
            : fn == kRmwBxor ? (cv ^ val)
                             : val;
        const bool rmw_absent =
            (obj_found && rd_val == 0) || (!obj_found && nf_quorum);
        const bool rmw_known = obj_found || nf_quorum;
        const bool rmw_commit =
            is_rmw && epoch_ok && (fn == kRmwPia ? rmw_absent : rmw_known);

        const bool commit =
            put_commit || cas_commit || rewrite || nf_write || rmw_commit;
        const int32_t wval = (is_put || is_cas) ? val
                             : is_rmw            ? new_rmw
                             : rewrite           ? rd_val
                                                 : 0;
        const int32_t new_seq = (int32_t)((uint32_t)ctr + (commit ? 1u : 0u));

        // Read repair of the divergent replicas on a plain read.
        const bool plain_read = get_ok && obj_found && !rewrite;
        const bool divergent = heard_m && (pe != rd_epoch || ps != rd_seq ||
                                           !leaf_ok || path_bad);
        const bool do_write = (commit && heard_m) || (plain_read && divergent);
        if (do_write) {
          const int32_t w_epoch = commit ? lead_epoch : rd_epoch;
          const int32_t w_seq = commit ? new_seq : rd_seq;
          const int32_t w_val = commit ? wval : rd_val;
          s_oe[o] = w_epoch;
          s_os[o] = w_seq;
          s_ov[o] = w_val;
          s_sst[o] = kDirty;  // its leaf is hashed at the end
#pragma unroll
          for (int l = 0; l < kMaxLevels; ++l) {
            if (l < lv.count) {
              uint8_t& st = s_nst[lane * U + path[l]];
              if (wide) {
                heal_m |= (st & kBad) != 0;
                st |= kDirty;
              } else {
                st = kDirty;
              }
            }
          }
        }
        wrote |= __ballot_sync(kFull, do_write);
        const uint32_t corrupt_bits = __ballot_sync(kFull, corrupt_m);
        group_bits |= corrupt_bits;
        ctr = new_seq;
        if (lane == src) {
          const bool served = get_ok && obj_found;
          r_commit = commit;
          r_get = get_ok;
          r_found = found && get_ok;
          r_value = rmw_commit ? new_rmw : (get_ok && found ? rd_val : 0);
          r_vsn0 = commit ? lead_epoch : (served ? rd_epoch : 0);
          r_vsn1 = commit ? new_seq : (served ? rd_seq : 0);
          r_corrupt = corrupt_bits;
        }
        __syncwarp();
      }
      if (have) {
        const size_t op = op_index<kWide>(p, base + lane, C, col);
        p.committed[op] = r_commit;
        p.get_ok[op] = r_get;
        p.found[op] = r_found;
        p.value[op] = r_value;
        p.obj_vsn[op * 2] = r_vsn0;
        p.obj_vsn[op * 2 + 1] = r_vsn1;
        p.quorum_ok[op] = epoch_ok;
        if (!wide)
          for (int r = 0; r < M; ++r)
            p.tree_corrupt[op * M + r] = (r_corrupt >> r) & 1u;
      }
      cur = nxt;
    }
    if (wide) leave_group(K);
    if (lane == 0) s_wrote = wrote;
  }

  // Follower epoch catch-up at the end of the launch; the ballot back.
  if (warp == 0) {
    const bool heard_m = (heard >> lane) & 1u;
    if (heard_m && leader_up && epoch_m < lead_epoch) epoch_m = lead_epoch;
    if (in) {
      p.epoch[(size_t)e * M + lane] = epoch_m;
      p.fact_seq[(size_t)e * M + lane] = fact_m;
    }
    if (lane == 0) {
      p.leader[e] = leader;
      p.obj_seq_ctr[e] = ctr;
    }
  }
  if (!stage) return;  // block-uniform
  __syncthreads();
  const uint32_t wrote = s_wrote;
  if (wrote == 0) return;  // block-uniform

  // The written slots' leaves, from their final objects.
  for (int i = threadIdx.x; i < MS; i += blockDim.x) {
    if (s_sst[i] & kDirty) {
#pragma unroll
      for (int l = 0; l < 4; ++l)
        s_leaf[i * 4 + l] = leaf_lane(s_oe[i], s_os[i], s_ov[i], l);
    }
  }
  __syncthreads();

  // Refold the DIRTY nodes bottom-up from their final children, eight a
  // warp step (one a quad).
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    if (l < lv.count) {
      const int total = M * lv.n[l];
      for (int base = warp * 8; base < total; base += nwarps * 8) {
        const int i = base + quad;
        const int r = i / lv.n[l], pidx = i - r * lv.n[l];
        const int n = lv.off[l] + pidx;
        const bool mine = i < total && ((wrote >> r) & 1u) &&
                          (s_nst[r * U + n] & kDirty);
        const uint32_t* child =
            l == 0 ? s_leaf + (size_t)r * S * 4
                   : s_node + ((size_t)r * U + lv.off[l > 0 ? l - 1 : 0]) * 4;
        const int cn = l == 0 ? S : lv.n[l > 0 ? l - 1 : 0];
        const uint32_t got =
            fold_quad(mine ? child : nullptr, cn, pidx, lane, s_consts);
        if (mine) s_node[((size_t)r * U + n) * 4 + li] = got;
      }
      __syncthreads();
    }
  }

  // Write back the replicas that wrote: TMA bulk stores, one thread per
  // replica (the object rows by every thread where S is not a multiple of
  // 4).  The generic-proxy writes above are fenced for the async proxy,
  // and the block waits only until its stores have read shared memory.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const bool row_tma = (S & 3) == 0;
  const int r = threadIdx.x;
  const bool mine = r < M && ((wrote >> r) & 1u);
  if (mine) {
    const size_t ro = obj_base + (size_t)r * S;
    if (row_tma) {
      bulk_s2g(p.obj_epoch + ro, s_oe + r * S, (uint32_t)S * 4);
      bulk_s2g(p.obj_seq + ro, s_os + r * S, (uint32_t)S * 4);
      bulk_s2g(p.obj_val + ro, s_ov + r * S, (uint32_t)S * 4);
    }
    bulk_s2g(p.tree_leaf + ro * 4, s_leaf + (size_t)r * S * 4,
             (uint32_t)S * 16);
    bulk_s2g(p.tree_node + node_base + (size_t)r * U * 4,
             s_node + (size_t)r * U * 4, (uint32_t)U * 16);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
  if (!row_tma) {
    for (int q = 0; q < M; ++q) {
      if (!((wrote >> q) & 1u)) continue;
      const size_t ro = obj_base + (size_t)q * S;
      for (int i = threadIdx.x; i < S; i += blockDim.x) {
        p.obj_epoch[ro + i] = s_oe[q * S + i];
        p.obj_seq[ro + i] = s_os[q * S + i];
        p.obj_val[ro + i] = s_ov[q * S + i];
      }
    }
  }
  if (mine) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Dynamic shared memory of one block: the object planes (each padded to
// 16 bytes), the leaves, the upper nodes, their state bytes and the
// slots' state bytes.
int smem_bytes(int m, int s, int u) {
  return 4 * 3 * pad4_host(m * s) + 16 * m * s + 16 * m * u +
         pad16_host(m * u) + pad16_host(m * s);
}

// The launch shape: warps per block from {1, 2, 4, 8} (at most 8, the
// kernel's bound).  Scalar: the one that needs the fewest waves of
// resident blocks for `a` blocks; on a tie the most warps (the verdicts
// and refolds spread over them).  Wide: the one that keeps the most warps
// on an SM at once (the launch's blocks an SM holds at once, times the
// warps a block), for its lanes' chains are latency-bound; on a tie the
// fewest warps a block (fewer block barriers a pass).  Occupancy comes
// from the runtime's own query.
struct Shape {
  int warps, blocks_per_sm, sms;
};

constexpr int kMaxDevices = 64;

// What the runtime said of one card, cached: the shared memory the kernel
// may take there (cudaFuncSetAttribute holds per device), its SMs, and
// the occupancy query's answers by shared-memory size.  Launches may come
// from threads, so shape_lock guards it.
struct DeviceCache {
  int smem_set[2] = {-1, -1};  // by mode: scalar, wide
  int sms = 0;
  int n = 0;
  int smem[16];
  int occ[16][2][4];
};

// The kernel of a mode.
const void* kernel_of(bool wide) {
  return wide ? (const void*)engine_step_kernel<true>
              : (const void*)engine_step_kernel<false>;
}
DeviceCache device_cache[kMaxDevices];
std::mutex shape_lock;

int occupancy(DeviceCache& dc, bool wide, int warps, int smem, int* blocks) {
  const int slot = warps == 1 ? 0 : warps == 2 ? 1 : warps == 4 ? 2 : 3;
  int i = 0;
  while (i < dc.n && dc.smem[i] != smem) ++i;
  if (i < dc.n && dc.occ[i][wide][slot] >= 0) {
    *blocks = dc.occ[i][wide][slot];
    return 0;
  }
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel_of(wide), warps * 32, smem);
  if (err != cudaSuccess) return (int)err;
  if (i == dc.n) {
    if (dc.n == 16) i = 0; else ++dc.n;
    dc.smem[i] = smem;
    for (int m = 0; m < 2; ++m)
      for (int q = 0; q < 4; ++q) dc.occ[i][m][q] = -1;
  }
  dc.occ[i][wide][slot] = *blocks;
  return 0;
}

// The shape of a launch of `a` blocks of the mode's kernel on the current
// device, after raising that kernel's dynamic shared memory limit there if
// it needs it.
int choose_shape(bool wide, int a, int smem, Shape* out) {
  std::lock_guard<std::mutex> hold(shape_lock);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidValue;
  DeviceCache& dc = device_cache[dev];
  if (smem > dc.smem_set[wide]) {
    err = cudaFuncSetAttribute(kernel_of(wide),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    dc.smem_set[wide] = smem;
  }
  if (dc.sms == 0) {
    err = cudaDeviceGetAttribute(&dc.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  int best = -1, best_waves = 0, best_occ = 0;
  long best_resident = 0;
  for (int w = 1; w <= kMaxWarps; w *= 2) {
    int occ = 0;
    const int rc = occupancy(dc, wide, w, smem, &occ);
    if (rc != 0) return rc;
    if (occ <= 0) continue;
    const long per_wave = (long)occ * dc.sms;
    const int waves = (int)((a + per_wave - 1) / per_wave);
    const long per_sm = ((long)a + dc.sms - 1) / dc.sms;
    const long resident = (occ < per_sm ? occ : per_sm) * w;
    if (best < 0 || (wide ? resident > best_resident : waves <= best_waves)) {
      best_resident = resident;
      best = w;
      best_waves = waves;
      best_occ = occ;
    }
  }
  if (best < 0) return (int)cudaErrorInvalidConfiguration;
  out->warps = best;
  out->blocks_per_sm = best_occ;
  out->sms = dc.sms;
  return 0;
}

int n_levels(int s) {
  int nlev = 0;
  for (int n = s; n > 1; n = (n + kWidth - 1) / kWidth) ++nlev;
  return nlev > 0 ? nlev : 1;
}

int check_dims(const int* dims) {
  if (dims[kM] < 1 || dims[kM] > kMaxPeers || dims[kV] < 1 ||
      dims[kV] > kMaxViews || dims[kS] < 1 || dims[kU] < 1 || dims[kK] < 0 ||
      dims[kW] < 1 || n_levels(dims[kS]) > kMaxLevels)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// Plain C entry point (bound with ctypes): `ptrs` holds the kNumPtrs
// device pointers in Ptr order, `dims` the kNumDims ints in Dim order.
// Launches on `stream`, a stream of the current device, and returns
// cudaGetLastError() as an int (0 = launched); never synchronises or
// allocates.
extern "C" int retpu_engine_step(const uint64_t* ptrs, const int* dims,
                                 void* stream) {
  Params p;
  p.epoch = (int32_t*)ptrs[kEpoch];
  p.fact_seq = (int32_t*)ptrs[kFactSeq];
  p.leader = (int32_t*)ptrs[kLeader];
  p.obj_seq_ctr = (int32_t*)ptrs[kObjSeqCtr];
  p.view_mask = (const uint8_t*)ptrs[kViewMask];
  p.obj_epoch = (int32_t*)ptrs[kObjEpoch];
  p.obj_seq = (int32_t*)ptrs[kObjSeq];
  p.obj_val = (int32_t*)ptrs[kObjVal];
  p.tree_leaf = (uint32_t*)ptrs[kTreeLeaf];
  p.tree_node = (uint32_t*)ptrs[kTreeNode];
  p.elect = (const uint8_t*)ptrs[kElect];
  p.cand = (const int32_t*)ptrs[kCand];
  p.kind = (const int32_t*)ptrs[kKind];
  p.slot = (const int32_t*)ptrs[kSlot];
  p.val = (const int32_t*)ptrs[kVal];
  p.lease_ok = (const uint8_t*)ptrs[kLeaseOk];
  p.exp_epoch = (const int32_t*)ptrs[kExpEpoch];
  p.exp_seq = (const int32_t*)ptrs[kExpSeq];
  p.up = (const uint8_t*)ptrs[kUp];
  p.fold_consts = (const uint32_t*)ptrs[kFoldConsts];
  p.won = (uint8_t*)ptrs[kWon];
  p.committed = (uint8_t*)ptrs[kCommitted];
  p.get_ok = (uint8_t*)ptrs[kGetOk];
  p.found = (uint8_t*)ptrs[kFound];
  p.value = (int32_t*)ptrs[kValue];
  p.obj_vsn = (int32_t*)ptrs[kObjVsn];
  p.quorum_ok = (uint8_t*)ptrs[kQuorumOk];
  p.tree_corrupt = (uint8_t*)ptrs[kTreeCorrupt];
  p.active_idx = (const int32_t*)ptrs[kActiveIdx];
  p.pad_ballot = (const int32_t*)ptrs[kPadBallot];
  p.e = dims[kE];
  p.m = dims[kM];
  p.s = dims[kS];
  p.u = dims[kU];
  p.v = dims[kV];
  p.k = dims[kK];
  p.a = dims[kA];
  p.w = dims[kW];
  if (p.e <= 0 || p.a <= 0) return 0;
  if (check_dims(dims) != 0 ||
      (p.elect != nullptr) != (p.won != nullptr) ||
      (p.active_idx == nullptr && p.a != p.e) ||
      (p.active_idx == nullptr && p.pad_ballot != nullptr))
    return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(p.m, p.s, p.u);
  Shape shape;
  const bool wide = p.w > 1;
  const int rc = choose_shape(wide, p.a, smem, &shape);
  if (rc != 0) return rc;
  if (wide)
    engine_step_kernel<true>
        <<<p.a, shape.warps * 32, smem, (cudaStream_t)stream>>>(p);
  else
    engine_step_kernel<false>
        <<<p.a, shape.warps * 32, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// What a launch with these dims would run as on the current device: out[0] registers per
// thread, [1] static shared memory, [2] dynamic shared memory, [3] local
// (spill) bytes per thread, [4] warps per block, [5] resident blocks per
// SM, [6] SMs.  Returns a CUDA error code (0 = filled).
extern "C" int retpu_engine_step_occupancy(const int* dims, int* out) {
  if (check_dims(dims) != 0) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const bool wide = dims[kW] > 1;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel_of(wide));
  if (err != cudaSuccess) return (int)err;
  const int smem = smem_bytes(dims[kM], dims[kS], dims[kU]);
  Shape shape;
  const int rc =
      choose_shape(wide, dims[kA] > 0 ? dims[kA] : 1, smem, &shape);
  if (rc != 0) return rc;
  out[0] = attr.numRegs;
  out[1] = (int)attr.sharedSizeBytes;
  out[2] = smem;
  out[3] = (int)attr.localSizeBytes;
  out[4] = shape.warps;
  out[5] = shape.blocks_per_sm;
  out[6] = shape.sms;
  return 0;
}
