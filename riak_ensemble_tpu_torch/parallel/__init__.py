"""Host services over the torch engine, and the device mesh."""

from riak_ensemble_tpu_torch.parallel.mesh import (  # noqa: F401
    ShardedEngine, make_mesh,
)
# repgroup imports on demand via `from riak_ensemble_tpu_torch.parallel
# import repgroup`, as in the reference
