// K1: the engine's quorum predicate as a CUDA kernel for Hopper (sm_90a).
//
// Replaces the Pallas kernel quorum_met_epallas
// (riak_ensemble_tpu/ops/pallas_quorum.py:172, body _ekernel :153-167,
// shared tail _resolve :41-63).  For every row r of a [R, M] vote
// batch and its [V, M] per-ensemble view mask it computes, per view v,
//
//   heard = sum_m mask*valid, n_nack = sum_m mask*nack,
//   members = sum_m mask, thresh = members/2 + 1,
//
// then MET (1) when every active view has heard >= thresh, else, for the
// FIRST unmet view in order, NACK (-1) when n_nack >= thresh or
// heard + n_nack == members, else UNDECIDED (0).  Views with no members
// are padding: always met, never nack.  This is quorum_met_batch with
// required="quorum" and no self term (the engine folds the leader's own
// vote into `valid`).
//
// Redesigned for the card rather than copied tile by tile:
// - one thread per row, counts in int32 registers (the TPU kernel
//   counted in f32 on 128-lane tiles and padded M to 128, V to 8);
// - the bool planes are read as bytes, unpadded;
// - rows may share a mask: row r reads mask row r / w, so the engine's
//   round call [E, W, M] needs no materialised [E, W, V, M] broadcast;
// - one 1-D grid over the R rows, ragged edge masked by `r < rows`.
//
// Bound on this card: bytes.  At the main-path shape (E = 10,000, M = 5,
// V = 2) one call reads ~200 KB and writes 10 KB — about 0.06 us at
// 3.35 TB/s, far under one launch, so the kernel is launch-bound; fusing
// it into the round (or a CUDA graph over the round loop) is the lever,
// not a faster body.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void quorum_met_kernel(const uint8_t* __restrict__ valid,
                                  const uint8_t* __restrict__ nack,
                                  const uint8_t* __restrict__ mask,
                                  int8_t* __restrict__ out,
                                  int rows, int m, int v, int w) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const uint8_t* va = valid + (size_t)r * m;
  const uint8_t* na = nack + (size_t)r * m;
  const uint8_t* mk = mask + (size_t)(r / w) * v * m;
  int8_t res = 1;  // MET unless some view is unmet
  for (int j = 0; j < v; ++j) {
    const uint8_t* mj = mk + (size_t)j * m;
    int members = 0, heard = 0, n_nack = 0;
    for (int p = 0; p < m; ++p) {
      const int in_view = mj[p] != 0;
      members += in_view;
      heard += in_view & (va[p] != 0);
      n_nack += in_view & (na[p] != 0);
    }
    if (members == 0) continue;  // inactive view: met, never nacks
    const int thresh = members / 2 + 1;
    if (heard >= thresh) continue;
    // first unmet view decides: nack or keep collecting
    res = (n_nack >= thresh || heard + n_nack == members) ? -1 : 0;
    break;
  }
  out[r] = res;
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches on `stream` and
// returns cudaGetLastError() as an int (0 = launched).  Does not
// synchronise and allocates nothing: the caller owns every buffer.
extern "C" int retpu_quorum_met(const void* valid, const void* nack,
                                const void* mask, void* out, int rows,
                                int m, int v, int w, void* stream) {
  if (rows <= 0) return 0;
  const int blocks = (rows + kThreads - 1) / kThreads;
  quorum_met_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)valid, (const uint8_t*)nack, (const uint8_t*)mask,
      (int8_t*)out, rows, m, v, w);
  return (int)cudaGetLastError();
}
