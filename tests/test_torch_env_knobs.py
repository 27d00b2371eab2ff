"""The port's environment knobs are documented — the mirror of
``tests/test_env_knobs.py`` for ``riak_ensemble_tpu_torch`` and
``chip_smoke.py``.

Every ``RETPU_*`` variable the port's source reads must have a row in
README.md's "Tuning knobs (environment)" table.  The table is shared
with the JAX package, whose own test requires every row to name a knob
that the JAX package reads; so the port may read only knobs the
reference also reads, or a row for it would break that test.
"""

import os
import re

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KNOB_RE = re.compile(r"RETPU_[A-Z0-9_]+")


def _knobs(roots):
    knobs = set()
    for root in roots:
        path = os.path.join(REPO, root)
        paths = [path] if os.path.isfile(path) else [
            os.path.join(d, f) for d, _dirs, files in os.walk(path)
            if not {"__pycache__", "build"}
            & set(os.path.relpath(d, path).split(os.sep))
            for f in files if f.endswith(".py")]
        for p in paths:
            with open(p, encoding="utf-8") as fh:
                knobs.update(KNOB_RE.findall(fh.read()))
    return knobs


def _readme_table():
    with open(os.path.join(REPO, "README.md"), encoding="utf-8") as fh:
        return set(re.findall(r"^\|\s*`(RETPU_[A-Z0-9_]+)`", fh.read(),
                              re.MULTILINE))


PORT = _knobs(("riak_ensemble_tpu_torch", "chip_smoke.py"))


def test_every_port_knob_is_documented():
    assert len(PORT) >= 33, sorted(PORT)
    missing = PORT - _readme_table()
    assert not missing, (
        f"undocumented RETPU_* knob(s) of the port {sorted(missing)}: add "
        "a row to README.md's 'Tuning knobs (environment)' table")


def test_every_port_knob_is_one_the_reference_reads():
    extra = PORT - _knobs(("riak_ensemble_tpu", "bench.py",
                           "tpu_attempt.py", "__graft_entry__.py"))
    assert not extra, (
        f"the port reads knob(s) {sorted(extra)} that the JAX package does "
        "not: a README row for them would fail tests/test_env_knobs.py")
