"""The service's observability plane.

Copied from ``riak_ensemble_tpu/obs/`` (``__init__``, ``registry``,
``spans``, ``flightrec``, ``opslo``, ``controller``, ``fleet``; the
fingerprint records the port's own stack), so the port imports nothing
of the JAX package:

- :mod:`.registry` — counters, gauges, fixed-bucket histograms and a
  label dimension, exported as plain JSON and Prometheus text
  (svcnode's ``metrics`` verb);
- :mod:`.spans` — the per-process ``flush_id`` allocator and the
  bounded store of per-flush span timelines;
- :mod:`.flightrec` — the ring of per-flush records with its anomaly
  trigger and dumps;
- :mod:`.fingerprint` — the box fingerprint every dump embeds;
- :mod:`.opslo` — the per-op SLO stamp ring;
- :mod:`.controller` — the runtime controller (observe-only unless
  ``RETPU_AUTOTUNE=1``) and its decision journal;
- :mod:`.fleet` — the standalone fleet surfaces (clock offsets,
  Prometheus merge, aligned timelines);
- :mod:`.watchdog` — the replication group's standing anomaly watchdog
  (``RETPU_WATCHDOG=0`` disarms its pulls).

The reference's ``compilewatch`` watches XLA compiles and is not
copied: the port counts its library builds instead
(:func:`..ops.build.add_listener`).

Knobs, as in the reference: ``RETPU_OBS=0`` disables hot-path
recording (instruments stay constructed; the service caches the answer
at construction); ``RETPU_OBS_DUMP_DIR`` directs flight-recorder dumps.
"""

from __future__ import annotations

import os

from riak_ensemble_tpu_torch.obs.controller import (DecisionJournal,
                                                    RuntimeController)
from riak_ensemble_tpu_torch.obs.fingerprint import box_fingerprint
from riak_ensemble_tpu_torch.obs.fleet import (ClockOffset,
                                               align_timeline,
                                               merge_prometheus)
from riak_ensemble_tpu_torch.obs.flightrec import FlightRecorder
from riak_ensemble_tpu_torch.obs.opslo import OpSloRing
from riak_ensemble_tpu_torch.obs.registry import (Counter, Gauge,
                                                  Histogram,
                                                  MetricsRegistry,
                                                  MS_BUCKETS)
from riak_ensemble_tpu_torch.obs.spans import (SPANS, SpanStore,
                                               next_flush_id, timeline)
from riak_ensemble_tpu_torch.obs.watchdog import AnomalyWatchdog

__all__ = ["MetricsRegistry", "Counter", "Gauge", "Histogram",
           "MS_BUCKETS", "FlightRecorder", "SpanStore", "SPANS",
           "next_flush_id", "timeline", "box_fingerprint", "enabled",
           "dump_dir", "OpSloRing", "RuntimeController",
           "DecisionJournal", "ClockOffset", "align_timeline",
           "merge_prometheus", "AnomalyWatchdog"]


def enabled() -> bool:
    """Whether hot-path recording is on (``RETPU_OBS=0`` opts out).

    Read the environment each call — services CACHE the answer at
    construction, so an A/B arm flips the knob and builds a fresh
    service."""
    return os.environ.get("RETPU_OBS", "1") != "0"


def dump_dir():
    """Flight-recorder dump directory (``RETPU_OBS_DUMP_DIR``); None
    keeps anomaly snapshots in memory only."""
    return os.environ.get("RETPU_OBS_DUMP_DIR") or None
