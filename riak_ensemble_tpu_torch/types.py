"""Client-visible sentinels and errors.

Copied unchanged from ``riak_ensemble_tpu/types.py`` (``_NotFound`` /
``NOTFOUND`` and the ``Timeout`` / ``Failed`` exceptions) — only what
the keyed service slice uses.  The port keeps its own copy so it
imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Optional


class _NotFound:
    """Singleton sentinel for missing keys / tombstones.

    The reference uses the atom ``notfound`` both as a read miss and as
    the value written by ``kdelete`` (a tombstone object whose value is
    ``notfound``).
    """

    _instance: Optional["_NotFound"] = None

    def __new__(cls) -> "_NotFound":
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:
        return "NOTFOUND"

    def __bool__(self) -> bool:
        return False


NOTFOUND = _NotFound()


# ---------------------------------------------------------------------------
# Client-visible results (std_reply(), riak_ensemble_types.hrl:8)

class Timeout(Exception):
    pass


class Failed(Exception):
    pass
