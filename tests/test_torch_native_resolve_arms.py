"""The port's oracle host arm against the JAX service's
(``RETPU_NATIVE_RESOLVE=0``), at depth 1 and 2 (the pass-level cases and
the shared helpers are in ``test_torch_native_resolve.py``).
"""

import pytest

from test_torch_native_enqueue import Pair
from test_torch_native_resolve import jb
from test_torch_reference_natives import reference_natives  # noqa: F401 (autouse)


@pytest.mark.parametrize("fast,compact,depth", [
    (True, True, 1), (True, True, 2), (False, True, 1), (True, False, 2),
    (False, False, 1)])
def test_oracle_arm_matches_jax_oracle(jb, monkeypatch, fast, compact,
                                       depth):
    """The port's ``False`` arms against the JAX ``=0`` arms: the per-entry
    pack and the per-op resolve loops on both sides."""
    p = Pair(jb, monkeypatch, "oracle", fast, compact, depth)
    p.run(seed=40 + depth + 2 * fast + 4 * compact)
    p.check()
    ts = p.ts
    assert ts.completion_wakes == ts.native_resolve_flushes == 0
    assert ts.fallback_resolve_flushes == ts.flushes > 0
