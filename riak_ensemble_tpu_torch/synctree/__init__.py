"""Integrity subsystem: the self-validating Merkle hash trie.

The host trie (:mod:`.tree`, a copy of the reference's, after
``src/synctree.erl``), the tree-server actor (:mod:`.peer_tree`), the
peer-to-peer exchange driver (:mod:`.exchange`), the stores behind the
trie and the WAL (:mod:`.backends`, :mod:`.native_store`) and the
streamed exchange of device trees between processes
(:mod:`.remote_sync`).  The device-side Merkle tree lives in
:mod:`riak_ensemble_tpu_torch.ops.hash`.
"""

from riak_ensemble_tpu_torch.synctree.tree import SyncTree, Corrupted, NONE  # noqa: F401
from riak_ensemble_tpu_torch.synctree.peer_tree import PeerTree  # noqa: F401
