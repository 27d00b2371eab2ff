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
// (quorum_met_bits, quorum_common.cuh) on 32-bit peer masks.  The torch
// loop it replaces (ops/engine.py kv_step_scan_plain) ran ~500 small
// kernels per round, 32,203 per K = 64 flush at 10,000 x 5 x 128.
//
// Semantics are full_step_plain's, bit for bit: every state plane is read
// and updated in place, and the stacked result planes [K, E] (tree_corrupt
// [K, E, M]) are written in the layout KvResult holds.
//
// What bounds it on this card.  At 10,000 x 5 x 128, K = 64: the state is
// 187.1 MB, read once and written once, plus ~13 MB of op planes and ~13 MB
// of result planes (~0.4 GB, ~0.12 ms at 3.35 TB/s); the hash work is
// ~10,000 int32 operations per ensemble per round (the path verify of
// every replica, the leaf hashes, the path write of every committing
// replica), ~6.3 G per flush, ~0.38 ms at the int32 rate (132 SMs x 64
// lanes x 1.98 GHz): operations bound it.  The rounds of one ensemble are
// sequential and every stage ends in a barrier, so latency, not either
// bound, sets its time: on an H100 80GB HBM3 at 700 W one launch took
// 2.13 ms, ~18 % of the bound (PERF.md).  The design:
// - one thread block per ensemble: rounds of one ensemble are sequential,
//   ensembles independent.  The block stages its ensemble's object and
//   tree planes into shared memory once (TMA 1-D bulk copies on an
//   mbarrier; coalesced 16-byte loads measured ~2 % slower, PERF.md),
//   runs all K rounds there and writes them back once.  At M = 5,
//   S = 128 that is ~18.7 KB per block;
// - warp w does the Merkle work of the replicas r = w (mod warps): a
//   16-child fold is one warp (lane = child pair x hash lane), the sum
//   over children a butterfly of shuffles, the cross-lane stir two more
//   shuffles — no block barrier inside a fold, and a replica's root-ward
//   path write needs only __syncwarp between levels;
// - the per-ensemble scalar logic (the election, the context, the
//   newest-object reductions, commit / CAS / RMW / tombstone / read
//   repair) runs on warp 0 with lane = replica: the peer reductions are
//   __reduce_max_sync and ballots;
// - three barriers per round: after the integrity checks, after the
//   decision (which writes the touched slot's object and leaf), and after
//   the path rewrite.
//
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

#include "quorum_common.cuh"

namespace {

constexpr int kMaxPeers = 32;
constexpr int kMaxViews = 8;
constexpr int kMaxLevels = 8;
constexpr int kMaxWarps = 8;
constexpr int kWidth = 16;  // Merkle trie fan-out
constexpr unsigned kFull = 0xffffffffu;

// op kinds (ops/engine.py OP_*) and RMW fun codes (funref.RMW_*)
constexpr int kOpGet = 1, kOpPut = 2, kOpCas = 3, kOpRmw = 4;
constexpr int kRmwAdd = 0, kRmwSub = 1, kRmwMax = 2, kRmwMin = 3,
              kRmwSet = 4, kRmwBand = 5, kRmwBor = 6, kRmwBxor = 7,
              kRmwPia = 8;

constexpr uint32_t kC1 = 0xCC9E2D51u;
constexpr uint32_t kF1 = 0x85EBCA6Bu;
constexpr uint32_t kF2 = 0xC2B2AE35u;

// Pointer slots of the entry point's `ptrs` array (ops/cuda_engine.py
// builds it in this order).
enum Ptr {
  kEpoch, kFactSeq, kLeader, kObjSeqCtr, kViewMask, kObjEpoch, kObjSeq,
  kObjVal, kTreeLeaf, kTreeNode, kElect, kCand, kKind, kSlot, kVal,
  kLeaseOk, kExpEpoch, kExpSeq, kUp, kFoldConsts, kWon, kCommitted,
  kGetOk, kFound, kValue, kObjVsn, kQuorumOk, kTreeCorrupt, kActiveIdx,
  kPadBallot, kNumPtrs
};
enum Dim { kE, kM, kS, kU, kV, kK, kA, kNumDims };

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
};

// ---------------------------------------------------------------------------
// The lane hash (ops/hash.py), on native uint32.

__device__ __forceinline__ uint32_t fmix(uint32_t h) {
  h ^= h >> 16;
  h *= kF1;
  h ^= h >> 13;
  h *= kF2;
  return h ^ (h >> 16);
}

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Lane `l` of obj_leaf_hash(epoch, seq, val).
__device__ __forceinline__ uint32_t leaf_lane(int32_t ep, int32_t sq,
                                              int32_t vl, int l) {
  const uint32_t e = (uint32_t)ep, s = (uint32_t)sq, v = (uint32_t)vl;
  uint32_t base;
  switch (l) {
    case 0: base = e ^ rotl(v, 5); break;
    case 1: base = s ^ rotl(v, 9); break;
    case 2: base = e ^ rotl(s, 7); break;
    default: base = s ^ rotl(e, 11); break;
  }
  return fmix(base * kC1 + (uint32_t)l);
}

// hash.fold of the 16 children of parent `pidx` in a per-replica level
// array `arr` ([n, 4] words, zero-padded past n), by one whole warp.  Lane
// = (child pair cp = lane >> 2: children cp and cp + 8) x (hash lane li =
// lane & 3).  Every lane returns the parent's hash lane li.
__device__ __forceinline__ uint32_t fold_warp(const uint32_t* arr, int n,
                                              int pidx, int lane,
                                              uint32_t salt0, uint32_t mul0,
                                              uint32_t salt1, uint32_t mul1) {
  const int li = lane & 3;
  const int c0 = pidx * kWidth + (lane >> 2);
  const int c1 = c0 + kWidth / 2;
  const uint32_t x0 = c0 < n ? arr[c0 * 4 + li] : 0u;
  const uint32_t x1 = c1 < n ? arr[c1 * 4 + li] : 0u;
  // each child avalanched with its position's salt and multiplier; the
  // mixes summed mod 2^32 over the 16 children (lane bits 2..4 hold cp)
  uint32_t acc = fmix((x0 ^ salt0) * mul0 + (uint32_t)li) +
                 fmix((x1 ^ salt1) * mul1 + (uint32_t)li);
  acc += __shfl_xor_sync(kFull, acc, 4);
  acc += __shfl_xor_sync(kFull, acc, 8);
  acc += __shfl_xor_sync(kFull, acc, 16);
  // the cross-lane stirs: torch.roll(acc, 1) gives lane j lane j - 1
  const int quad = lane & ~3;
  acc = fmix(acc ^ __shfl_sync(kFull, acc, quad | ((li + 3) & 3)));
  acc ^= __shfl_sync(kFull, acc, quad | ((li + 2) & 3));
  return fmix(acc ^ (uint32_t)kWidth);
}

// The round context's epoch check on warp 0 (lane = replica): the leader's
// epoch (0 with no leader), whether it is up, and whether the heard members
// at that epoch reach a quorum in every view.
__device__ __forceinline__ bool epoch_check(int32_t epoch_m, int leader,
                                            uint32_t heard, bool in, int m,
                                            const uint32_t* views, int v,
                                            int32_t* lead_epoch,
                                            bool* leader_up) {
  const bool leader_in = leader >= 0 && leader < m;
  int32_t le = __shfl_sync(kFull, epoch_m, leader_in ? leader : 0);
  if (!leader_in) le = 0;
  const bool lu = leader_in && ((heard >> leader) & 1u);
  const uint32_t ack = heard & __ballot_sync(kFull, in && epoch_m == le);
  *lead_epoch = le;
  *leader_up = lu;
  return lu && quorum_met_bits(ack, heard & ~ack, views, v) == 1;
}

// ---------------------------------------------------------------------------
// Staging: TMA 1-D bulk copies on an mbarrier.

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

// Copy n 32-bit words; 16-byte vectors when both ends allow it.  Stages
// object rows that TMA cannot take (M * S not a multiple of 4) and writes
// every plane back.
__device__ __forceinline__ void copy_words(uint32_t* dst, const uint32_t* src,
                                           int n) {
  if ((((uintptr_t)dst | (uintptr_t)src) & 15) == 0 && (n & 3) == 0) {
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(dst);
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x) d4[i] = s4[i];
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  }
}

__device__ __forceinline__ int pad4(int n) { return (n + 3) & ~3; }
inline int pad4_host(int n) { return (n + 3) & ~3; }

// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kMaxWarps * 32)
    engine_step_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint32_t s_views[kMaxViews];
  __shared__ int s_flags[kMaxPeers];  // bit 0 leaf bad, bit 1 path bad
  __shared__ uint32_t s_write;        // replicas that write this round
  __shared__ __align__(8) uint64_t s_bar;

  const int E = p.e, M = p.m, S = p.s, U = p.u, V = p.v, K = p.k;
  const int C = p.a;  // columns of the op, election and result planes
  const int col = blockIdx.x;
  const int e = p.active_idx ? p.active_idx[col] : col;  // the state row
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int MS = M * S;

  if (e >= E) {
    // A pad column: the epoch check of row E - 1 as it stood before the
    // launch, then NOOP results for every round.
    if (warp != 0) return;
    const int row = E - 1;
    const bool in = lane < M;
    uint32_t views_any = 0;
    for (int j = 0; j < V; ++j) {
      const bool b = in && p.view_mask[((size_t)row * V + j) * M + lane];
      const uint32_t bits = __ballot_sync(kFull, b);
      if (lane == 0) s_views[j] = bits;
      views_any |= bits;
    }
    __syncwarp();
    const uint32_t heard =
        __ballot_sync(kFull, in && p.up[(size_t)row * M + lane]) & views_any;
    const int32_t* ballot_epoch =
        p.pad_ballot ? p.pad_ballot : p.epoch + (size_t)row * M;
    const int32_t epoch_m = in ? ballot_epoch[lane] : 0;
    const int leader = p.pad_ballot ? p.pad_ballot[M] : p.leader[row];
    int32_t lead_epoch;
    bool leader_up;
    const bool epoch_ok = epoch_check(epoch_m, leader, heard, in, M, s_views,
                                      V, &lead_epoch, &leader_up);
    if (lane == 0 && p.won != nullptr) p.won[col] = 0;
    for (int j = lane; j < K; j += 32) {
      const size_t op = (size_t)j * C + col;
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

  const size_t obj_base = (size_t)e * MS;
  const size_t leaf_base = obj_base * 4;
  const size_t node_base = (size_t)e * M * U * 4;

  // Stage the planes the rounds read and write (none when K = 0).
  if (K > 0) {
    // TMA needs 16-byte aligned rows: the object rows are when M * S is a
    // multiple of 4, the tree rows always are.
    const bool obj_tma = (MS & 3) == 0;
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_u32(&s_bar))
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0) {
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
    if (!obj_tma) {
      copy_words((uint32_t*)s_oe, (const uint32_t*)p.obj_epoch + obj_base, MS);
      copy_words((uint32_t*)s_os, (const uint32_t*)p.obj_seq + obj_base, MS);
      copy_words((uint32_t*)s_ov, (const uint32_t*)p.obj_val + obj_base, MS);
    }
    mbar_wait(&s_bar, 0);
  }

  // The trie's upper levels, leafward -> root (engine.tree_sizes).
  int nlev = 0;
  int lvl_n[kMaxLevels], lvl_off[kMaxLevels];
  {
    int n = S, off = 0;
#pragma unroll
    for (int l = 0; l < kMaxLevels; ++l) {
      if (n > 1) {
        n = (n + kWidth - 1) / kWidth;
        lvl_n[l] = n;
        lvl_off[l] = off;
        off += n;
        nlev = l + 1;
      }
    }
    if (nlev == 0) {
      lvl_n[0] = 1;
      lvl_off[0] = 0;
      nlev = 1;
    }
  }
  // This lane's fold constants: children cp and cp + 8.
  const int cp = lane >> 2;
  const uint32_t salt0 = p.fold_consts[cp], salt1 = p.fold_consts[cp + 8];
  const uint32_t mul0 = p.fold_consts[16 + cp];
  const uint32_t mul1 = p.fold_consts[16 + cp + 8];

  // Warp 0, lane = replica: ballot state, election and round context.
  const bool in = lane < M;
  int32_t epoch_m = 0, fact_m = 0, leader = 0, ctr = 0, lead_epoch = 0;
  uint32_t heard = 0, views_any = 0;
  bool leader_up = false, epoch_ok = false;
  int n_member = 0;
  if (warp == 0) {
    for (int j = 0; j < V; ++j) {
      const bool b = in && p.view_mask[((size_t)e * V + j) * M + lane];
      const uint32_t bits = __ballot_sync(kFull, b);
      if (lane == 0) s_views[j] = bits;
      views_any |= bits;
    }
    __syncwarp();
    heard = __ballot_sync(kFull, in && p.up[(size_t)e * M + lane]) &
            views_any;
    if (in) {
      epoch_m = p.epoch[(size_t)e * M + lane];
      fact_m = p.fact_seq[(size_t)e * M + lane];
    }
    leader = p.leader[e];
    ctr = p.obj_seq_ctr[e];
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
                       quorum_met_bits(heard, 0u, s_views, V) == 1;
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
    epoch_ok = epoch_check(epoch_m, leader, heard, in, M, s_views, V,
                           &lead_epoch, &leader_up);
    n_member = __popc(views_any);
  }
  __syncthreads();

  for (int j = 0; j < K; ++j) {
    const size_t op = (size_t)j * C + col;
    const int slot = p.slot[op];
    const bool slot_valid = slot >= 0 && slot < S;
    const int sc = slot < 0 ? 0 : (slot >= S ? S - 1 : slot);

    // Stage 1, every warp: the integrity gate of each replica at the slot —
    // the object against its leaf, and every stored parent on the root-ward
    // path against the fold of its stored children.
    for (int r = warp; r < M; r += nwarps) {
      const int o = r * S + sc;
      const int32_t pe = slot_valid ? s_oe[o] : 0;
      const int32_t ps = slot_valid ? s_os[o] : 0;
      const int32_t pv = slot_valid ? s_ov[o] : 0;
      const int li = lane & 3;
      const bool leaf_bad =
          __ballot_sync(kFull, leaf_lane(pe, ps, pv, li) != s_leaf[o * 4 + li]);
      bool path_bad = false;
      const uint32_t* child = s_leaf + (size_t)r * S * 4;
      int child_n = S;
      const uint32_t* node_r = s_node + (size_t)r * U * 4;
      int idx = sc;
#pragma unroll
      for (int l = 0; l < kMaxLevels; ++l) {
        if (l < nlev) {
          const int pidx = idx / kWidth;
          const uint32_t parent = fold_warp(child, child_n, pidx, lane, salt0,
                                            mul0, salt1, mul1);
          const uint32_t stored = node_r[(lvl_off[l] + pidx) * 4 + li];
          path_bad |= __ballot_sync(kFull, parent != stored) != 0u;
          child = node_r + lvl_off[l] * 4;
          child_n = lvl_n[l];
          idx = pidx;
        }
      }
      if (lane == 0) s_flags[r] = (leaf_bad ? 1 : 0) | (path_bad ? 2 : 0);
    }
    __syncthreads();

    // Stage 2, warp 0 (lane = replica): the round's decision.
    if (warp == 0) {
      const int kind = p.kind[op];
      const int32_t val = p.val[op];
      const bool lease = p.lease_ok[op];
      const int32_t exp_e = p.exp_epoch ? p.exp_epoch[op] : 0;
      const int32_t exp_s = p.exp_seq ? p.exp_seq[op] : 0;
      const bool is_put = kind == kOpPut, is_get = kind == kOpGet;
      const bool is_cas = kind == kOpCas, is_rmw = kind == kOpRmw;
      const bool active = is_put || is_get || is_cas || is_rmw;

      const bool heard_m = (heard >> lane) & 1u;
      const int o = lane * S + sc;
      const int32_t pe = in && slot_valid ? s_oe[o] : 0;
      const int32_t ps = in && slot_valid ? s_os[o] : 0;
      const int32_t pv = in && slot_valid ? s_ov[o] : 0;
      const int flags = in ? s_flags[lane] : 0;
      const bool leaf_ok = !(flags & 1), path_bad = (flags & 2) != 0;
      const bool ok_m = heard_m && leaf_ok && !path_bad;
      const uint32_t okmask = __ballot_sync(kFull, ok_m);
      const bool corrupt_m =
          (path_bad || !leaf_ok) && heard_m && active && slot_valid;

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

      const bool get_gate = is_get && leader_up && (lease || epoch_ok);
      const bool stale = obj_found && rd_epoch != lead_epoch;
      const bool rewrite = get_gate && stale && epoch_ok;
      const bool nf = get_gate && !obj_found;
      const bool nf_quorum =
          quorum_met_bits(okmask, heard & ~okmask, s_views, V) == 1;
      const bool nf_write =
          nf && slot_valid && !all_ok && epoch_ok && nf_quorum;
      const bool get_ok = (get_gate && obj_found && (!stale || rewrite)) ||
                          (nf && (all_ok || !slot_valid || nf_write));

      const bool put_commit = is_put && epoch_ok && slot_valid;
      const bool exp_absent = exp_e == 0 && exp_s == 0;
      const bool vsn_match =
          (obj_found && rd_epoch == exp_e && rd_seq == exp_s) ||
          (exp_absent && obj_found && rd_val == 0) ||
          (exp_absent && !obj_found && nf_quorum);
      const bool cas_commit = is_cas && epoch_ok && slot_valid && vsn_match;

      // Device RMW: fn(cur, operand); + and - wrap mod 2^32 as in torch.
      const int fn = exp_e;
      const int32_t cur = rd_val;
      int32_t new_rmw;
      switch (fn) {
        case kRmwAdd: new_rmw = (int32_t)((uint32_t)cur + (uint32_t)val); break;
        case kRmwSub: new_rmw = (int32_t)((uint32_t)cur - (uint32_t)val); break;
        case kRmwMax: new_rmw = cur > val ? cur : val; break;
        case kRmwMin: new_rmw = cur < val ? cur : val; break;
        case kRmwSet: new_rmw = val; break;
        case kRmwBand: new_rmw = cur & val; break;
        case kRmwBor: new_rmw = cur | val; break;
        case kRmwBxor: new_rmw = cur ^ val; break;
        default: new_rmw = val; break;  // RMW_PIA commits the operand
      }
      const bool rmw_absent =
          (obj_found && rd_val == 0) || (!obj_found && nf_quorum);
      const bool rmw_known = obj_found || nf_quorum;
      const bool rmw_commit = is_rmw && epoch_ok && slot_valid &&
                              (fn == kRmwPia ? rmw_absent : rmw_known);

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
      const int32_t w_epoch = commit ? lead_epoch : rd_epoch;
      const int32_t w_seq = commit ? new_seq : rd_seq;
      const int32_t w_val = commit ? wval : rd_val;
      if (do_write) {
        s_oe[o] = w_epoch;
        s_os[o] = w_seq;
        s_ov[o] = w_val;
#pragma unroll
        for (int l = 0; l < 4; ++l)
          s_leaf[o * 4 + l] = leaf_lane(w_epoch, w_seq, w_val, l);
      }
      const uint32_t wmask = __ballot_sync(kFull, do_write);
      ctr = new_seq;

      if (lane == 0) {
        s_write = wmask;
        const bool served = get_ok && obj_found;
        p.committed[op] = commit;
        p.get_ok[op] = get_ok;
        p.found[op] = found && get_ok;
        p.value[op] = rmw_commit ? new_rmw : (get_ok && found ? rd_val : 0);
        p.obj_vsn[op * 2] = commit ? lead_epoch : (served ? rd_epoch : 0);
        p.obj_vsn[op * 2 + 1] = commit ? new_seq : (served ? rd_seq : 0);
        p.quorum_ok[op] = epoch_ok;
      }
      if (in) p.tree_corrupt[op * M + lane] = corrupt_m;
    }
    __syncthreads();

    // Stage 3, every warp: the writing replicas' root-ward paths are
    // refolded level by level from their post-write children.
    const uint32_t wmask = s_write;
    for (int r = warp; r < M; r += nwarps) {
      if (!((wmask >> r) & 1u)) continue;
      const uint32_t* child = s_leaf + (size_t)r * S * 4;
      int child_n = S;
      uint32_t* node_r = s_node + (size_t)r * U * 4;
      int idx = sc;
#pragma unroll
      for (int l = 0; l < kMaxLevels; ++l) {
        if (l < nlev) {
          const int pidx = idx / kWidth;
          const uint32_t parent = fold_warp(child, child_n, pidx, lane, salt0,
                                            mul0, salt1, mul1);
          if (lane < 4) node_r[(lvl_off[l] + pidx) * 4 + lane] = parent;
          __syncwarp();
          child = node_r + lvl_off[l] * 4;
          child_n = lvl_n[l];
          idx = pidx;
        }
      }
    }
    __syncthreads();
  }

  // Follower epoch catch-up at the end of the launch, then write back.
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
  if (K > 0) {
    copy_words((uint32_t*)p.obj_epoch + obj_base, (const uint32_t*)s_oe, MS);
    copy_words((uint32_t*)p.obj_seq + obj_base, (const uint32_t*)s_os, MS);
    copy_words((uint32_t*)p.obj_val + obj_base, (const uint32_t*)s_ov, MS);
    copy_words(p.tree_leaf + leaf_base, s_leaf, MS * 4);
    copy_words(p.tree_node + node_base, s_node, M * U * 4);
  }
}

// Dynamic shared memory of one block: the object planes (each padded to
// 16 bytes), the leaves and the upper nodes of its ensemble.
int smem_bytes(int m, int s, int u) {
  return 4 * 3 * pad4_host(m * s) + 16 * m * s + 16 * m * u;
}

}  // namespace

// Plain C entry point (bound with ctypes): `ptrs` holds the kNumPtrs
// device pointers in Ptr order, `dims` the kNumDims ints in Dim order.
// Launches on `stream` and returns cudaGetLastError() as an int (0 =
// launched); never synchronises or allocates.
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
  if (p.e <= 0 || p.a <= 0) return 0;
  if (p.m < 1 || p.m > kMaxPeers || p.v < 1 || p.v > kMaxViews ||
      p.s < 1 || p.u < 1 || p.k < 0 ||
      (p.elect != nullptr) != (p.won != nullptr) ||
      (p.active_idx == nullptr && p.a != p.e) ||
      (p.active_idx == nullptr && p.pad_ballot != nullptr))
    return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(p.m, p.s, p.u);
  const int warps = p.m < kMaxWarps ? p.m : kMaxWarps;
  cudaError_t err = cudaFuncSetAttribute(
      engine_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  engine_step_kernel<<<p.a, warps * 32, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
