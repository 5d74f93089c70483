"""Followers: the ranks above 0 of a :class:`~repro_torch.serve.DKSService`
over a graph split one shard a rank.

Rank 0 leads.  Its service keeps everything a service does (admission,
the result and tree-pool caches, single-flight, the batcher, deadlines,
traces, stats and metrics), and before every call that reaches the engine
its dispatcher thread sends one :class:`Record` over the control channel
(:func:`repro_torch.distributed.comm.broadcast_object`).  The other ranks
run :func:`follow`: they receive each record, run the same call on their
shard, in the same order, and drop what it returns: every rank gets the
same result (the frontier exchange, ``QueryEngine._agreed``), and only
rank 0 resolves futures.

Records, in the order rank 0 sends them:

  ``open``  a service started on rank 0's build ``version``: the engine
            :func:`follow` was given.
  ``call``  ``engine.<method>(queries, **kwargs)`` on build ``version``:
            a bucket (``query_batch``, ``query_deadline_batch``, padding
            lanes included) or a direct call routed through the
            dispatcher (:meth:`DKSService.on_engine`).
  ``swap``  build the successor of build ``version`` from ``target``
            (:func:`repro_torch.live.swap.describe_target`) with
            ``policy``, warm ``shapes`` in order, and make it current.
  ``stop``  the service stopped: :func:`follow` returns.

A follower reads no clock to decide anything: a deadline record carries
the budget rank 0 computed, and the follower runs the bucket with no
budget of its own, so rank 0's clock alone ends it and ``_agreed`` stops
every rank at that superstep.  It keeps the last :data:`KEEP_BUILDS`
builds, so requests admitted before a swap finish on their admitting
build; rank 0 refuses to dispatch a bucket of an older one.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import Any

from repro_torch.distributed import comm

KEEP_BUILDS = 2          # builds a follower keeps: the current and the last
LOG_RECORDS = 4096       # records kept in rank 0's and each follower's log
METHODS = ("query", "query_batch", "query_deadline", "query_deadline_batch")


@dataclasses.dataclass(frozen=True)
class Record:
    """One step of the record stream (see the module docstring)."""

    kind: str                      # "open" | "call" | "swap" | "stop"
    version: Any = None            # rank 0's build the step runs on
    method: str | None = None      # call: the engine method
    queries: Any = None            # call: its first argument
    kwargs: dict | None = None     # call: its keyword arguments
    target: tuple | None = None    # swap: describe_target's tuple
    policy: Any = None             # swap: the successor's policy
    shapes: tuple = ()             # swap: the (m, k, lanes) to warm


def hold(builds: dict, version: Any, value: Any) -> None:
    """Make ``version`` the newest of ``builds`` and drop all but the
    :data:`KEEP_BUILDS` newest (rank 0 and its followers keep the same
    versions this way)."""
    builds.pop(version, None)
    builds[version] = value
    while len(builds) > KEEP_BUILDS:
        del builds[next(iter(builds))]


def follow(engine: Any) -> list[Record]:
    """Replay rank 0's records on ``engine`` (this rank's shard of the
    build rank 0's service starts on) until a ``stop`` record; returns
    the log of the records replayed (the last :data:`LOG_RECORDS`).  A
    replay that raises ends the call with that error."""
    from repro_torch.live.swap import (build_successor, open_target,
                                       warm_engine)

    log: collections.deque = collections.deque(maxlen=LOG_RECORDS)
    builds: dict = {}
    while True:
        rec = comm.broadcast_object()
        log.append(rec)
        if rec.kind == "stop":
            return list(log)
        if rec.kind == "open":
            if isinstance(rec.version, str) and rec.version != \
                    engine.version:
                raise RuntimeError(f"rank 0 serves {rec.version}, this rank "
                                   f"holds {engine.version}")
            builds = {rec.version: engine}
            continue
        if rec.version not in builds:
            raise RuntimeError(f"record names build {rec.version!r}, which "
                               f"this rank does not hold")
        if rec.kind == "call":
            if rec.method not in METHODS:
                raise ValueError(f"record names no engine call: "
                                 f"{rec.method!r}")
            kwargs = dict(rec.kwargs)
            if "deadline_s" in kwargs:     # rank 0's clock decides
                kwargs["deadline_s"] = math.inf
            getattr(builds[rec.version], rec.method)(rec.queries, **kwargs)
        elif rec.kind == "swap":
            new = build_successor(builds[rec.version],
                                  open_target(rec.target), rec.policy)
            warm_engine(new, rec.shapes)
            hold(builds, new.version, new)
        else:
            raise ValueError(f"unknown record kind {rec.kind!r}")
