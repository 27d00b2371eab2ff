"""Device-side code of the port: the quorum predicate and its CUDA
kernel, the Merkle lane hash, and the fused engine step."""

from riak_ensemble_tpu_torch.ops.quorum import (  # noqa: F401
    MET,
    UNDECIDED,
    NACK,
    quorum_met,
    quorum_met_batch,
)
