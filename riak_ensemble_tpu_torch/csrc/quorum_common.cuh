// The quorum predicate's shared tail, for every kernel that judges votes:
// K1 and K2 (quorum.cu), the fused engine step F1 (engine_step.cu), the
// exchange X1 (exchange_step.cu) and the reconfig step R1
// (reconfig_step.cu).
//
// For one view v of a vote row: members = |mask_v|, heard = votes for,
// n_nack = votes against, thresh = members/2 + 1 (members in mode "all").
// The row is MET (1) when every view with members is met (heard >=
// thresh); otherwise the FIRST unmet view, in order, decides it: NACK (-1)
// when n_nack >= thresh or heard + n_nack == members, else UNDECIDED (0).
// Views with no members are padding: always met, never nack.  This is the
// TPU kernels' _resolve (riak_ensemble_tpu/ops/pallas_quorum.py:41-63) and
// riak_ensemble_msg:quorum_met/5 (msg.erl:377-418).
#pragma once

#include <stdint.h>

// Returns false when the view is met (or inactive) and the caller goes on
// to the next view; returns true, with *res set to NACK or UNDECIDED, when
// this is the first unmet view — which decides the row.
__device__ __forceinline__ bool resolve_view(int heard, int n_nack,
                                             int members, int thresh,
                                             int8_t* res) {
  if (members == 0 || heard >= thresh) return false;
  *res = (n_nack >= thresh || heard + n_nack == members) ? -1 : 0;
  return true;
}

// required="quorum" with no self term, for peers held as 32-bit masks
// (M <= 32): `views[j]` is view j's members, `valid` / `nack` the votes.
__device__ __forceinline__ int8_t quorum_met_bits(uint32_t valid,
                                                  uint32_t nack,
                                                  const uint32_t* views,
                                                  int v) {
  int8_t res = 1;
  for (int j = 0; j < v; ++j) {
    const int members = __popc(views[j]);
    if (resolve_view(__popc(views[j] & valid), __popc(views[j] & nack),
                     members, members / 2 + 1, &res))
      break;
  }
  return res;
}
