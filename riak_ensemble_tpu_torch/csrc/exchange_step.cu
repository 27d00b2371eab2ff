// X1: the anti-entropy exchange as ONE CUDA kernel for Hopper (sm_90a).
//
// What it replaces.  K1's redesign for the exchange path, as F1 is K1's
// redesign for the flush: engine.exchange_step ran K1 (the quorum
// predicate, replacing the TPU kernel quorum_met_epallas,
// riak_ensemble_tpu/ops/pallas_quorum.py:172) once, plus some 30 Torch
// passes over the whole store — XLA's fusion of the reference's
// exchange_step (riak_ensemble_tpu/ops/engine.py:1139-1219).  Here the
// predicate, the slot pass and the replica pass run inside one launch.
//
// Semantics are exchange_step_plain's, bit for bit.  Per row e, with
// heard = up & member (member: in any view):
// - adopt = run[e] & quorum(heard, heard) in every view (nack = 0),
//   through quorum_common.cuh's resolve_view on peer masks;
// - a row outside `run`, or without the quorum, keeps every plane and
//   reports diverged = 0 and synced = 0: only its `run` byte (and masks)
//   are read.  So the work grows with the adopting rows, not with
//   E x M x S;
// - node verdicts: node_ok per heard replica is the fold of the OLD
//   leaves against tree_node.  Rebuilt and stored levels agree everywhere
//   iff every stored node equals the fold of its stored children (by
//   induction up the levels), so each node is checked on its own, as F1's
//   staging checks its verdicts, with no scratch level;
// - slot pass, parallel over S (a thread a slot), walking the heard
//   replicas of its slot twice: first each one's leaf_ok (the lane hash of
//   its object against its leaf) and the newest hash-valid holder (max
//   epoch, then seq, then val — the torch body's three masked maxima,
//   whose epoch maximum is floored at -1 as soon as one replica of the row
//   is not a holder); then the mismatch against the winner, for diverged,
//   and where a winner exists the adoption: the object and its leaf are
//   written where they differ;
// - rebuild: the upper levels of the gate replicas refolded from the NEW
//   leaves, level by level behind a block barrier, each node written where
//   it differs — for the replicas whose leaves were written or whose
//   verdicts failed only: any other gate replica's rebuild equals its
//   stored levels (the same induction), so skipping it changes no bit.
// Every plane is stepped IN PLACE; the caller keeps the run rows' planes
// where it needs a rollback (parallel/batched_host.py scrub).
//
// What bounds it on this card.  At 10,000 x 5 x 128 the store is 186 MB;
// an exchange must read the heard replicas of the adopting rows and write
// what changes, so 3 flagged rows move ~120 KB and every row ~180 MB
// (~0.054 ms at 3.35 TB/s), and hash every leaf and fold every node of
// them once.  Neither sets the time: a row is a chain of dependent steps
// on one block of 128 threads, ~10 us on an H100 (PERF.md), so the time
// is rows in flight against that chain.  The design shortens the chain
// and keeps the card's blocks on flagged rows:
// - a persistent grid, one resident wave of blocks, each taking every
//   G-th row of a permuted order (row k * mult mod E, mult coprime to E,
//   so that a periodic pattern such as every third row spreads over the
//   blocks): a block reads its rows' `run` bytes together and steps only
//   the flagged ones, so 3 flagged rows cost one wave that reads ~10 KB
//   and three rows' chains, not E blocks;
// - every warp ballots the row's masks itself, so no barrier stands
//   before the reads: the masks' and the first slot chunk's loads go out
//   together, and one barrier separates every read of the old planes
//   (first walk, verdicts) from the writes (second walk);
// - a slot's replicas load in chunks whose loads all issue before any is
//   used; the second walk re-reads the objects from L1;
// - the rebuild runs only where something changed (above).
// Tried and measured slower (PERF.md): one block per row with E blocks
// (each early exit costs a wave slot), a grid over rows in their own order
// (every third row left two thirds of the blocks idle), verdicts for every
// replica before the masks, and L2 prefetches of the next row.
//
// Contract (the Python wrapper checks it and raises; the entry point
// refuses it again): 1 <= M <= 128 (4-word peer masks; one word, its own
// instantiation, where M <= 32), 1 <= V <= 8 (K1's contract), S >= 1,
// contiguous planes, tree_leaf on a 16-byte boundary.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "quorum_common.cuh"
#include "tree_hash.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kWords = 4;       // peer masks: M <= 128
constexpr int kMaxViews = 8;
constexpr int kChunk = 6;       // replicas whose loads issue together
constexpr int kMinBlocks = 4;   // resident blocks an SM at least

struct XParams {
  int32_t* obj_epoch;  // [E, M, S]
  int32_t* obj_seq;
  int32_t* obj_val;
  uint32_t* tree_leaf;  // [E, M, S, 4]
  uint32_t* tree_node;  // [E, M, U, 4]
  const uint8_t* view_mask;  // [E, V, M]
  const uint8_t* up;         // [E, M]
  const uint8_t* run;        // [E]
  const uint32_t* fold_consts;  // 16 salts, then 16 odd multipliers
  uint8_t* diverged;  // [E, M]
  uint8_t* synced;    // [E]
  int e, m, s, u, v;
  int mult;  // the walk's row permutation (row_of)
};

// Word i of a kW-word peer mask held in registers, and w[i] |= v, by
// selects: a runtime index into a register array would put it in local
// memory.
template <int kW>
__device__ __forceinline__ uint32_t word(const uint32_t (&w)[kW], int i) {
  uint32_t x = w[0];
#pragma unroll
  for (int k = 1; k < kW; ++k)
    if (i == k) x = w[k];
  return x;
}

template <int kW>
__device__ __forceinline__ void or_word(uint32_t (&w)[kW], int i,
                                        uint32_t v) {
#pragma unroll
  for (int k = 0; k < kW; ++k)
    if (i == k) w[k] |= v;
}

template <int kW>
__device__ __forceinline__ bool bit(const uint32_t (&w)[kW], int r) {
  return (word(w, r >> 5) >> (r & 31)) & 1u;
}

// The newest hash-valid holder of a slot so far, in the torch body's
// order (maximum epoch, then seq among those, then val), and the number
// of holders seen.
struct Holder {
  int32_t e = 0, s = 0, v = 0;
  int n = 0;
};

// One heard replica of a slot, for both walks of the slot pass: its
// leaf_ok (the lane hash of its object against its leaf), returned, and,
// if it is a hash-valid holder (seq > 0), its place in `h`.
__device__ __forceinline__ bool take_replica(int32_t oe, int32_t os,
                                             int32_t ov, uint4 lf,
                                             Holder& h) {
  const bool lok = leaf_lane(oe, os, ov, 0) == lf.x &&
                   leaf_lane(oe, os, ov, 1) == lf.y &&
                   leaf_lane(oe, os, ov, 2) == lf.z &&
                   leaf_lane(oe, os, ov, 3) == lf.w;
  if (lok && os > 0) {
    if (h.n == 0 || oe > h.e ||
        (oe == h.e && (os > h.s || (os == h.s && ov > h.v)))) {
      h.e = oe;
      h.s = os;
      h.v = ov;
    }
    ++h.n;
  }
  return lok;
}

// Whether the slot has a winner (`found`), once every heard replica was
// taken; without one the target is all zero.  The torch body's epoch
// maximum runs over every replica, the others at -1: with a non-holder
// in the row, holders below -1 never win.
__device__ __forceinline__ bool settle(Holder& h, int m) {
  const bool found = h.n > 0 && (h.n == m || h.e >= -1);
  if (!found) h.e = h.s = h.v = 0;
  return found;
}

template <int kW>
struct Shared {
  uint32_t consts[2 * kWidth];  // the fold's salts, multipliers
  uint32_t div[kW];       // diverged gate replicas
  uint32_t rebuild[kW];   // gate replicas whose upper levels may change
  uint32_t todo[kWarps];  // a chunk's run rows, by warp
};

// Upper node n of a replica's flat node array (engine.tree_sizes
// leafward -> root): its index in its level, and where its children lie
// — the leaves (`*child_off` -1) or the level below, at that offset —
// with their count.  Walked from S, with no level table in registers.
__device__ __forceinline__ int node_children(int n, int s, int* child_off,
                                             int* child_n) {
  int size = s > 1 ? (s + kWidth - 1) / kWidth : 1;
  int off = 0, coff = -1, cn = s;
  while (n >= off + size) {
    coff = off;
    cn = size;
    off += size;
    size = (size + kWidth - 1) / kWidth;
  }
  *child_off = coff;
  *child_n = cn;
  return n - off;
}

// One row, by the whole block (every thread calls it with the same row).
// Every warp ballots the row's masks itself, so no barrier stands before
// the reads: the masks' and the first slot's loads go out together, the
// slot pass's first walk and the node verdicts read the old planes, and
// one barrier separates every read from the writes.  Only the replicas
// whose leaves were written or whose nodes failed their verdicts have
// their upper levels rebuilt: another gate replica's rebuild equals its
// stored levels (every node equals the fold of its children, by induction
// up the levels), so skipping it changes no bit.
template <int kW>
__device__ __forceinline__ void exchange_row(const XParams& p,
                                             Shared<kW>& sh, int e) {
  const int M = p.m, S = p.s, U = p.u, V = p.v;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint8_t* div_row = p.diverged + (size_t)e * M;
  const size_t row_obj = (size_t)e * M * S;  // replica r's slot s: + r*S + s
  const size_t row_node = (size_t)e * M * U;
  const int quad = lane >> 2, li = lane & 3;
  __syncthreads();  // the previous row's readers of `sh` are done

  // This thread's first slot: its first chunk of replicas, loads issued
  // with the masks'.
  const int s0 = threadIdx.x;
  int32_t oe[kChunk], os[kChunk], ov[kChunk];
  uint4 lf[kChunk];
  if (s0 < S) {
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (k < M) {
        const size_t i = row_obj + (size_t)k * S + s0;
        oe[k] = p.obj_epoch[i];
        os[k] = p.obj_seq[i];
        ov[k] = p.obj_val[i];
        lf[k] = reinterpret_cast<const uint4*>(p.tree_leaf)[i];
      }
    }
  }
  // The row's views and heard members as kW-word peer masks, in every
  // warp: word w from a ballot over peers [32w, 32w + 32), a byte each.
  const uint8_t* vm = p.view_mask + (size_t)e * V * M;
  uint32_t views[kMaxViews][kW], heard[kW];
#pragma unroll
  for (int w = 0; w < kW; ++w) {
    const int peer = w * 32 + lane;
    const bool in = peer < M;
    bool member[kMaxViews];
#pragma unroll
    for (int j = 0; j < kMaxViews; ++j)
      member[j] = in && j < V && vm[(size_t)j * M + peer];
    const bool up = in && p.up[(size_t)e * M + peer];
    uint32_t any = 0;
#pragma unroll
    for (int j = 0; j < kMaxViews; ++j) {
      views[j][w] = __ballot_sync(kFull, member[j]);
      any |= views[j][w];
    }
    heard[w] = __ballot_sync(kFull, up) & any;
  }
  // adopt = quorum(heard, heard): K1's predicate with no nacks
  int8_t res = 1;
  bool decided = false;  // the first unmet view decides the row
#pragma unroll
  for (int j = 0; j < kMaxViews; ++j) {
    int members = 0, n_heard = 0;
#pragma unroll
    for (int w = 0; w < kW; ++w) {
      members += __popc(views[j][w]);
      n_heard += __popc(views[j][w] & heard[w]);
    }
    if (j < V && !decided)
      decided = resolve_view(n_heard, 0, members, members / 2 + 1, &res);
  }
  if (res != 1) {
    for (int r = threadIdx.x; r < M; r += kThreads) div_row[r] = 0;
    if (threadIdx.x == 0) p.synced[e] = 0;
    return;
  }
  if (threadIdx.x < kW) {
    sh.div[threadIdx.x] = 0;
    sh.rebuild[threadIdx.x] = 0;
  }

  // Slot pass, first walk (reads only): each slot's leaf_ok and newest
  // hash-valid holder over the heard replicas, in chunks of kChunk whose
  // loads all issue before any is used.  The chunk's replica is the same
  // in every thread, so skipping one that is not heard is uniform.
  const int n_mine = s0 < S ? (S - 1 - s0) / kThreads + 1 : 0;
  // kept for the second walk: the first slot's results (a thread holds
  // more than one slot only when S > kThreads; those re-walk below)
  uint32_t ok0[kW] = {};
  Holder h0;
  bool found0 = false;
  if (n_mine > 0) {
    for (int base = 0; base < M; base += kChunk) {
      if (base > 0) {
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          const int r = base + k;
          if (r < M && bit(heard, r)) {
            const size_t i = row_obj + (size_t)r * S + s0;
            oe[k] = p.obj_epoch[i];
            os[k] = p.obj_seq[i];
            ov[k] = p.obj_val[i];
            lf[k] = reinterpret_cast<const uint4*>(p.tree_leaf)[i];
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const int r = base + k;
        // a chunk may cross a mask word: each replica sets its own bit
        if (r < M && bit(heard, r) &&
            take_replica(oe[k], os[k], ov[k], lf[k], h0))
          or_word(ok0, r >> 5, 1u << (r & 31));
      }
    }
    found0 = settle(h0, M);
  }

  // Replica pass, first half: the node verdicts of the heard replicas —
  // each stored node against the fold of its stored children (old
  // leaves).
  uint32_t div[kW], rebuild[kW];
#pragma unroll
  for (int w = 0; w < kW; ++w) div[w] = rebuild[w] = 0;
  for (int base = warp * 8; base < M * U; base += kWarps * 8) {
    const int i = base + quad;
    const int r = i < M * U ? i / U : 0, n = i - r * U;
    const bool mine = i < M * U && bit(heard, r);
    int coff, cn;
    const int pidx = node_children(mine ? n : 0, S, &coff, &cn);
    const uint32_t* child =
        coff < 0 ? p.tree_leaf + (row_obj + (size_t)r * S) * 4
                 : p.tree_node + (row_node + (size_t)r * U + coff) * 4;
    const uint32_t got =
        fold_quad(mine ? child : nullptr, cn, pidx, lane, sh.consts);
    const uint32_t diff = __ballot_sync(
        kFull,
        mine && got != p.tree_node[(row_node + (size_t)r * U + n) * 4 + li]);
    if (mine && li == 0 && ((diff >> (lane & ~3)) & 0xFu))
      or_word(div, r >> 5, 1u << (r & 31));
  }
#pragma unroll
  for (int w = 0; w < kW; ++w) rebuild[w] = div[w];
  __syncthreads();  // every old plane read before one is written

  // Slot pass, second walk: the mismatch against the winner, and the
  // adoption (objects re-read from L1; a later slot of this thread is
  // walked again first).
  for (int t = 0; t < n_mine; ++t) {
    const int s = s0 + t * kThreads;
    uint32_t ok[kW];
    Holder h = h0;
    bool found = found0;
#pragma unroll
    for (int w = 0; w < kW; ++w) ok[w] = ok0[w];
    if (t > 0) {
      h = Holder();
#pragma unroll
      for (int w = 0; w < kW; ++w) {
        ok[w] = 0;
        for (uint32_t bits = heard[w]; bits; bits &= bits - 1) {
          const int r = w * 32 + __ffs(bits) - 1;
          const size_t i = row_obj + (size_t)r * S + s;
          if (take_replica(p.obj_epoch[i], p.obj_seq[i], p.obj_val[i],
                           reinterpret_cast<const uint4*>(p.tree_leaf)[i],
                           h))
            ok[w] |= 1u << (r & 31);
        }
      }
      found = settle(h, M);
    }
    const int32_t we = h.e, ws = h.s, wv = h.v;
    uint4 nl = make_uint4(0, 0, 0, 0);
    if (found)
      nl = make_uint4(leaf_lane(we, ws, wv, 0), leaf_lane(we, ws, wv, 1),
                      leaf_lane(we, ws, wv, 2), leaf_lane(we, ws, wv, 3));
#pragma unroll
    for (int w = 0; w < kW; ++w) {
      for (uint32_t bits = heard[w]; bits; bits &= bits - 1) {
        const int r = w * 32 + __ffs(bits) - 1;
        const size_t i = row_obj + (size_t)r * S + s;
        const bool mismatch = p.obj_epoch[i] != we || p.obj_seq[i] != ws ||
                              p.obj_val[i] != wv;
        const bool lok = (ok[w] >> (r & 31)) & 1u;
        if (mismatch || !lok) div[w] |= 1u << (r & 31);
        if (!found) continue;
        if (mismatch) {
          p.obj_epoch[i] = we;
          p.obj_seq[i] = ws;
          p.obj_val[i] = wv;
        }
        if (mismatch || !lok) {
          reinterpret_cast<uint4*>(p.tree_leaf)[i] = nl;
          rebuild[w] |= 1u << (r & 31);
        }
      }
    }
  }
#pragma unroll
  for (int w = 0; w < kW; ++w) {
    const uint32_t d = __reduce_or_sync(kFull, div[w]);
    const uint32_t b = __reduce_or_sync(kFull, rebuild[w]);
    if (lane == 0 && d) atomicOr(&sh.div[w], d);
    if (lane == 0 && b) atomicOr(&sh.rebuild[w], b);
  }
  __syncthreads();  // every new leaf written before the uppers fold them

  // Replica pass, second half: the upper levels of the replicas to
  // rebuild, from the new leaves, leafward -> root, one level a step.
#pragma unroll
  for (int w = 0; w < kW; ++w) rebuild[w] = sh.rebuild[w];
  bool any_rebuild = false;
#pragma unroll
  for (int w = 0; w < kW; ++w) any_rebuild |= rebuild[w] != 0;
  if (any_rebuild) {
    int size = S > 1 ? (S + kWidth - 1) / kWidth : 1;
    for (int off = 0, coff = -1, cn = S; off < U;
         coff = off, cn = size, off += size,
             size = (size + kWidth - 1) / kWidth) {
      for (int base = warp * 8; base < M * size; base += kWarps * 8) {
        const int i = base + quad;
        const bool in = i < M * size;
        const int r = in ? i / size : 0, pidx = in ? i - r * size : 0;
        const bool go = in && bit(rebuild, r);
        const uint32_t* child =
            coff < 0 ? p.tree_leaf + (row_obj + (size_t)r * S) * 4
                     : p.tree_node + (row_node + (size_t)r * U + coff) * 4;
        const uint32_t got =
            fold_quad(go ? child : nullptr, cn, pidx, lane, sh.consts);
        if (go) {
          uint32_t* dst =
              p.tree_node + (row_node + (size_t)r * U + off + pidx) * 4 + li;
          if (*dst != got) *dst = got;
        }
      }
      __syncthreads();
    }
  }

  for (int r = threadIdx.x; r < M; r += kThreads)
    div_row[r] = bit(heard, r) && ((sh.div[r >> 5] >> (r & 31)) & 1u);
  if (threadIdx.x == 0) p.synced[e] = 1;
}

// Row k of the walk, in an order that spreads any run pattern over the
// blocks: e = k * mult mod E, `mult` coprime to E (near 0.618 E).
__device__ __forceinline__ int row_of(const XParams& p, int k) {
  return (int)(((long long)k * p.mult) % p.e);
}

// A persistent grid: block b takes rows row_of(b), row_of(b + G), ... (G
// blocks, about one resident wave).  It reads their `run` bytes a chunk
// of kThreads rows at a time (one load each), writes the results of the
// rows outside `run`, and steps the rows in `run` one after another.
// kW: the 32-bit words of a peer mask (1 up to 32 peers, else 4).
template <int kW>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    exchange_step_kernel(const XParams p) {
  __shared__ Shared<kW> sh;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int G = gridDim.x;
  if (threadIdx.x < 2 * kWidth) sh.consts[threadIdx.x] = p.fold_consts[threadIdx.x];
  const int rows = (p.e - blockIdx.x + G - 1) / G;  // this block's rows
  for (int k0 = 0; k0 < rows; k0 += kThreads) {
    const int k = k0 + threadIdx.x;
    bool flagged = false;
    if (k < rows) {
      const int e = row_of(p, blockIdx.x + k * G);
      flagged = p.run[e] != 0;
      if (!flagged) {
        uint8_t* d = p.diverged + (size_t)e * p.m;
        for (int r = 0; r < p.m; ++r) d[r] = 0;
        p.synced[e] = 0;
      }
    }
    __syncthreads();  // the previous chunk's walk has read `todo`
    const uint32_t fb = __ballot_sync(kFull, flagged);
    if (lane == 0) sh.todo[warp] = fb;
    __syncthreads();
    for (int w = 0; w < kWarps; ++w)
      for (uint32_t bits = sh.todo[w]; bits; bits &= bits - 1)
        exchange_row<kW>(
            p, sh,
            row_of(p, blockIdx.x + (k0 + w * 32 + __ffs(bits) - 1) * G));
  }
}

// The persistent grid of kernel `fn`: the blocks one wave of the current
// card holds (its SMs x the resident blocks an SM takes of it), cached
// per device and mask width.  Returns a CUDA error code; 0 with
// `*blocks` set.
int wave_blocks(const void* fn, int slot, int* blocks) {
  static std::mutex mu;
  static int cache[64][2] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  std::lock_guard<std::mutex> guard(mu);
  if (dev < 64 && cache[dev][slot] > 0) {
    *blocks = cache[dev][slot];
    return 0;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                        kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  if (sms * per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  if (dev < 64) cache[dev][slot] = sms * per_sm;
  *blocks = sms * per_sm;
  return 0;
}

}  // namespace

// Plain C entry point (bound with ctypes): `ptrs` holds the 11 device
// pointers in XParams order, `dims` E, M, S, U, V.  Launches one wave of
// blocks (at most E) on `stream` and returns cudaGetLastError() as an int (0 = launched); never
// synchronises or allocates.
extern "C" int retpu_exchange_step(const uint64_t* ptrs, const int* dims,
                                   void* stream) {
  XParams p;
  p.obj_epoch = (int32_t*)ptrs[0];
  p.obj_seq = (int32_t*)ptrs[1];
  p.obj_val = (int32_t*)ptrs[2];
  p.tree_leaf = (uint32_t*)ptrs[3];
  p.tree_node = (uint32_t*)ptrs[4];
  p.view_mask = (const uint8_t*)ptrs[5];
  p.up = (const uint8_t*)ptrs[6];
  p.run = (const uint8_t*)ptrs[7];
  p.fold_consts = (const uint32_t*)ptrs[8];
  p.diverged = (uint8_t*)ptrs[9];
  p.synced = (uint8_t*)ptrs[10];
  p.e = dims[0];
  p.m = dims[1];
  p.s = dims[2];
  p.u = dims[3];
  p.v = dims[4];
  if (p.e <= 0) return 0;
  if (p.m < 1 || p.m > kWords * 32 || p.v < 1 || p.v > kMaxViews || p.s < 1)
    return (int)cudaErrorInvalidValue;
  // the walk's multiplier: the first integer from 0.618 E up that is
  // coprime to E
  long long mult = (long long)(0.6180339887 * p.e);
  if (mult < 1) mult = 1;
  for (;;) {
    long long a = mult, b = p.e;
    while (b) {
      const long long t = a % b;
      a = b;
      b = t;
    }
    if (a == 1) break;
    ++mult;
  }
  p.mult = (int)mult;
  const bool narrow = p.m <= 32;  // one word a peer mask
  const void* fn = narrow ? (const void*)exchange_step_kernel<1>
                          : (const void*)exchange_step_kernel<kWords>;
  int wave = 0;
  const int rc = wave_blocks(fn, narrow ? 0 : 1, &wave);
  if (rc != 0) return rc;
  const int grid = p.e < wave ? p.e : wave;
  if (narrow)
    exchange_step_kernel<1><<<grid, kThreads, 0, (cudaStream_t)stream>>>(p);
  else
    exchange_step_kernel<kWords>
        <<<grid, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
