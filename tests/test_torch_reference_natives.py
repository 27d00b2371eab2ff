"""The JAX package's C++ libraries (``native/*.so``) for the port's tests
that hold the port against the JAX service.

The reference builds each library at its first use in a process with
``make -C native``, whose rules link the ``.so`` in place.  In a parallel
test run every worker does that at once, on a fresh checkout while the
reference's own test modules are being collected (their ``skipif`` marks
load the libraries at import).  A worker that opens a library while
another worker's linker is rewriting it, or finds it missing in between,
gets None and keeps None for the rest of its life: the loader memoises
the failure.  In that worker the JAX service then runs without its C++
host passes and its WAL without the C++ store, and every port test that
holds the two services' arms together fails there (the reference's own
native tests skip there, which the port's tests cannot reach).

:func:`reference_natives`, an autouse fixture the port's test modules
import, makes sure the libraries are loaded in the worker before such a
test: under an exclusive lock that every test process shares, it loads
them, and where a load failed it forgets the failure and loads again
once the concurrent build has finished.  The module holds no test of
its own.
"""

import fcntl
import os
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOCK = os.path.join(ROOT, "riak_ensemble_tpu_torch", "build",
                    "reference-natives.lock")
ATTEMPTS = 6


def load_reference_natives() -> None:
    """Load the reference's ``libretpu_native.so`` (clock, treestore) and
    ``_retpu_resolve.so`` (the host passes) in this process, and clear the
    memoised failures of the loaders that sit on them; raise if they do
    not load after a few tries."""
    from riak_ensemble_tpu.parallel import enqueue_native, resolve_native
    from riak_ensemble_tpu.utils import native
    os.makedirs(os.path.dirname(LOCK), exist_ok=True)
    with open(LOCK, "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            for attempt in range(ATTEMPTS):
                if native.load() is not None \
                        and native.load_resolve() is not None:
                    break
                # a concurrent make was writing a library: forget the
                # failure and load again after it finishes
                native._tried = native._resolve_tried = False
                time.sleep(0.5 * (attempt + 1))
            else:
                raise RuntimeError("the JAX package's native libraries did "
                                   f"not load in {ATTEMPTS} tries")
            for mod in (enqueue_native, resolve_native):
                if mod._instance is None:
                    mod._instance_tried = False
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


@pytest.fixture(autouse=True, scope="session")
def reference_natives():
    """The libraries loaded before the importing module's first test."""
    load_reference_natives()
