"""The native host arms of the port's service against the JAX service's,
on the default arm and on every mixed arm (split from
test_torch_native_enqueue.py, which keeps the pass-level cases and the
shared helpers).
"""

import pytest

from test_torch_native_enqueue import Pair, jb
from test_torch_reference_natives import reference_natives  # noqa: F401 (autouse)


@pytest.mark.parametrize("fast,compact,depth", [
    (True, True, 1), (True, True, 2), (False, True, 2), (True, False, 1),
    (False, False, 2)])
def test_default_arm_matches_jax_default(jb, monkeypatch, fast, compact,
                                         depth):
    """The port's default host arm against the JAX service's default
    (``RETPU_NATIVE_ENQUEUE`` / ``RETPU_NATIVE_RESOLVE`` unset)."""
    p = Pair(jb, monkeypatch, "default", fast, compact, depth)
    p.run(seed=depth + 2 * fast + 4 * compact)
    p.check()
    ts = p.ts
    assert ts.native_enqueue_flushes > 0 and ts.fallback_enqueue_flushes == 0
    assert ts.native_resolve_flushes > 0
    assert ts.completion_wakes == ts.native_enqueue_flushes
    if compact:
        assert ts.sliced_launches > 0


@pytest.mark.parametrize("arm,depth,compact", [
    ("enqueue_only", 1, True), ("enqueue_only", 2, False),
    ("resolve_only", 1, True), ("resolve_only", 2, False)])
def test_mixed_arms_match_jax(jb, monkeypatch, arm, depth, compact):
    """One native half alone against the JAX service with the other knob
    at 0: the slab path with the Python unpack and mirror walk
    (``RETPU_NATIVE_RESOLVE=0``), and the per-op loops over the C++
    unpack and mirror scatter, which skip their own mirror writes
    (``RETPU_NATIVE_ENQUEUE=0``)."""
    p = Pair(jb, monkeypatch, arm, compact=compact, depth=depth)
    p.run(seed=30 + depth)
    p.check()
    ts = p.ts
    if arm == "enqueue_only":
        assert ts.native_enqueue_flushes == ts.completion_wakes > 0
        assert ts.native_resolve_flushes == 0
    else:
        assert ts.native_resolve_flushes > 0
        assert ts.completion_wakes == ts.native_enqueue_flushes == \
            ts.fallback_enqueue_flushes == 0
