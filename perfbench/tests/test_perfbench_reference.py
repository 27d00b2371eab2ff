"""The reference on hand-built histories."""

from perfbench import reference as ref


def _t():
    return ref.Tally()


def test_puts_take_the_ensemble_s_next_seq_in_submit_order():
    t = _t()
    ens = ref.replay([
        (ref.PUT, ["a", "b", "a"], [b"1", b"2", b"3"],
         [("ok", (1, 1)), ("ok", (1, 2)), ("ok", (1, 3))]),
        (ref.GET, ["a", "b"], None,
         [("ok", b"3", (1, 3)), ("ok", b"2", (1, 2))]),
    ], t)
    assert t.as_dict() == {"get_mismatch": 0, "put_vsn_mismatch": 0,
                           "failed_ops": 0, "unanswered_ops": 0}
    assert ens.get("a") == (b"3", (1, 3))


def test_a_stale_read_a_wrong_value_and_a_wrong_version_are_counted():
    t = _t()
    ref.replay([
        (ref.PUT, ["a"], [b"1"], [("ok", (1, 1))]),
        (ref.PUT, ["a"], [b"2"], [("ok", (1, 1))]),        # wrong vsn
        (ref.GET, ["a", "a", "a"], None,
         [("ok", b"1", (1, 1)),                            # stale
          ("ok", b"x", (1, 2)),                            # wrong value
          ("ok", b"2", (1, 2))]),                          # right
    ], t)
    assert t.put_vsn_mismatch == 1
    assert t.get_mismatch == 2


def test_failed_and_unanswered_ops_are_counted_and_not_applied():
    t = _t()
    ens = ref.replay([
        (ref.PUT, ["a"], [b"1"], [("ok", (1, 1))]),
        (ref.PUT, ["a", "b"], [b"2", b"3"], ["failed", ("ok", (1, 2))]),
        (ref.PUT, ["c"], [b"4"], None),
    ], t)
    assert t.failed == 1 and t.unanswered == 1
    assert ens.get("a") == (b"1", (1, 1))
    assert ens.get("c") is None


def test_read_back_and_replicas_against_the_final_state():
    ens = ref.replay([(ref.PUT, ["a", "b"], [b"1", b"2"],
                       [("ok", (1, 1)), ("ok", (1, 2))])], _t())
    good = [("ok", b"1", (1, 1)), ("ok", b"2", (1, 2))]
    assert ref.compare_reads(ens, ["a", "b"], good) == 0
    assert ref.compare_reads(ens, ["a", "b"],
                             [good[0], ("ok", b"2", (1, 1))]) == 1
    assert ref.compare_reads(ens, ["a", "b"], None) == 2
    a, b = (b"1", (1, 1)), (b"2", (1, 2))
    stale = (b"0", (1, 0))
    assert ref.replica_short(ens, {"a": [a, a, a, stale, stale],
                                   "b": [b, b, b, b, b]}, 3) == 0
    assert ref.replica_short(ens, {"a": [a, a, stale, stale, stale],
                                   "b": [b, b, b, b, b]}, 3) == 1
    assert ref.replica_short(ens, {"a": [a, a, a], "b": [b, b]}, 3) == 1
