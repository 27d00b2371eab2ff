"""Device mod-fun table codes.

Copied unchanged from ``riak_ensemble_tpu/funref.py``: the RMW table
codes and the merge-class codes, which the engine reads.  The registry
(``register`` / ``ref`` / ``resolve`` / ``register_device``) and the
host-mirror table funs stay behind until the kmodify slice, whose
service methods are their first caller.  The port keeps its own copy
so it imports nothing of the JAX package.

A device-expressible modify function runs INSIDE a consensus round as
an ``OP_RMW`` op: the fun code rides the op's ``exp_epoch`` plane and
the operand its ``val`` plane (:mod:`.ops.engine`).
"""

#: device mod-fun table codes — the ``exp_epoch`` plane of an
#: ``OP_RMW`` row carries one of these
RMW_ADD = 0     # cur + operand            (absent/tombstone cur = 0)
RMW_SUB = 1     # cur - operand
RMW_MAX = 2     # max(cur, operand)
RMW_MIN = 3     # min(cur, operand)
RMW_SET = 4     # operand (unconditional overwrite)
RMW_BAND = 5    # cur & operand
RMW_BOR = 6    # cur | operand
RMW_BXOR = 7    # cur ^ operand
RMW_PIA = 8     # put-if-absent: operand iff nothing committed

#: merge-section cell fun codes (disjoint from the RMW_* table codes:
#: they name the FOLD, not the op — applied replica-side against the
#: lane's own current value)
MERGE_ADD = 0   # cur + folded operand (int32 wraparound)
MERGE_MAX = 1   # max(cur, folded operand)
MERGE_MIN = 2   # min(cur, folded operand)
MERGE_AND = 3   # cur & folded operand
MERGE_OR = 4    # cur | folded operand
