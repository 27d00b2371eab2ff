// The device Merkle tree's lane hash and trie layout, shared by every
// kernel that hashes replica trees: the engine step F1 (engine_step.cu)
// and the anti-entropy exchange X1 (exchange_step.cu).
//
// fmix / leaf_lane are ops/hash.py's murmur3 finalizer and
// obj_leaf_hash lane by lane on native uint32; fold_quad is hash.fold of
// one parent's 16 children by a quad of warp lanes (both kernels); and
// Levels / levels_of / children_of walk the width-16 trie's upper levels
// (engine.tree_sizes) in a replica's flat node array from a level table
// held in registers (F1; X1 walks the levels from S instead, to keep its
// registers for rows in flight).
#pragma once

#include <stdint.h>

constexpr int kWidth = 16;  // Merkle trie fan-out
constexpr unsigned kFull = 0xffffffffu;

constexpr uint32_t kC1 = 0xCC9E2D51u;
constexpr uint32_t kF1 = 0x85EBCA6Bu;
constexpr uint32_t kF2 = 0xC2B2AE35u;

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

// hash.fold of one parent's 16 children, by a quad of lanes: lane li =
// lane & 3 of the quad sums hash lane li of the children (each avalanched
// with its position's salt and multiplier, mod 2^32), then the stirs go
// round the quad.  The whole warp calls it, each quad for its own parent
// (`arr` null: an idle quad, zeros).  Quad q takes the children in the
// order q, q + 1, ... (mod 16) — the same sum — so that eight quads over
// one level array read eight banks.  `consts`: 16 salts, 16 multipliers.
__device__ __forceinline__ uint32_t fold_quad(const uint32_t* arr, int n,
                                              int pidx, int lane,
                                              const uint32_t* consts) {
  const int li = lane & 3;
  const int rot = lane >> 2;
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < kWidth; ++i) {
    const int c = (i + rot) & (kWidth - 1);
    const int ci = pidx * kWidth + c;
    const uint32_t x = (arr != nullptr && ci < n) ? arr[ci * 4 + li] : 0u;
    acc += fmix((x ^ consts[c]) * consts[kWidth + c] + (uint32_t)li);
  }
  // the cross-lane stirs: torch.roll(acc, 1) gives lane j lane j - 1
  const int quad = lane & ~3;
  acc = fmix(acc ^ __shfl_sync(kFull, acc, quad | ((li + 3) & 3)));
  acc ^= __shfl_sync(kFull, acc, quad | ((li + 2) & 3));
  return fmix(acc ^ (uint32_t)kWidth);
}

// ---------------------------------------------------------------------------
// The trie's upper levels, leafward -> root (engine.tree_sizes): their
// sizes and offsets in a replica's node array, for tries of at most
// kTrieLevels upper levels (S <= 65,536).  Indexed only by unrolled loop
// counters, so they stay in registers.

constexpr int kTrieLevels = 4;

struct Levels {
  int n[kTrieLevels];
  int off[kTrieLevels];
  int count;
};

__device__ __forceinline__ Levels levels_of(int s) {
  Levels lv;
  int n = s, off = 0;
  lv.count = 0;
#pragma unroll
  for (int l = 0; l < kTrieLevels; ++l) {
    lv.n[l] = 0;
    lv.off[l] = 0;
    if (n > 1) {
      n = (n + kWidth - 1) / kWidth;
      lv.n[l] = n;
      lv.off[l] = off;
      off += n;
      lv.count = l + 1;
    }
  }
  if (lv.count == 0) {
    lv.n[0] = 1;
    lv.count = 1;
  }
  return lv;
}

// Upper node `n` of a replica: its level's index in `*pidx`, and the
// array of its children (the replica's leaves, or the level below) with
// their count.
__device__ __forceinline__ const uint32_t* children_of(
    const Levels& lv, int n, const uint32_t* leaf_r, const uint32_t* node_r,
    int s, int* pidx, int* child_n) {
  int l = 0;
#pragma unroll
  for (int t = 1; t < kTrieLevels; ++t)
    if (t < lv.count && n >= lv.off[t]) l = t;
  int noff = 0, coff = 0, cn = s;
#pragma unroll
  for (int t = 0; t < kTrieLevels; ++t) {
    if (t == l) noff = lv.off[t];
    if (t + 1 == l) {
      coff = lv.off[t];
      cn = lv.n[t];
    }
  }
  *pidx = n - noff;
  *child_n = cn;
  return l == 0 ? leaf_r : node_r + coff * 4;
}
