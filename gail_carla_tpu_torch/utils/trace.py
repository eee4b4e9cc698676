"""Named spans on the program's layers.

``with span(name):`` marks one layer's work. When nothing listens it
costs one flag check and opens nothing. Under ``torch.profiler`` it opens
a ``torch.profiler.record_function``, so the span lands in the Chrome
trace (category ``user_annotation``) on the profiler's clock, beside the
device's kernels, copies and sets. Inside ``recording()`` it appends
``(name, parent, t0_ns, t1_ns)`` on the host clock
(``time.perf_counter_ns``) to the recorder that ``recording()`` returns,
without the profiler's cost per operation. A recorder keeps the spans of
one thread.

The spans and where they open:

- ``learner.rollout``, ``learner.validation`` (both calls),
  ``learner.critic``, ``learner.relabel``, ``learner.returns``,
  ``learner.ppo``: ``algo/learner.py::WDGAILLearner.update``
- ``rollout.obs``: ``algo/buffers.py::obs_batch`` (the render and the obs)
- ``rollout.store``: ``algo/rollout.py::collect_rollout`` (the packed store)
- ``policy.act``: ``models/policy.py::act``
- ``env.step`` and, inside it, ``sim.traffic``: ``sim/env.py::step_batch``
"""
from __future__ import annotations

import collections
import contextlib
import time

import torch
from torch.autograd import profiler as _autograd_profiler

NULL = contextlib.nullcontext()
_active = None      # the Recorder of the innermost open recording()


class Recorder:
    """Spans in the order they closed: ``(name, parent name or None,
    t0_ns, t1_ns)``."""

    def __init__(self):
        self.spans = []
        self._open = []                 # [name, ns covered by children]
        self._self_ns = collections.Counter()

    def calls(self) -> dict:
        """Closed spans per name."""
        return dict(collections.Counter(s[0] for s in self.spans))

    def host_ms(self) -> dict:
        """Host ms per name, each span's whole interval."""
        out = collections.Counter()
        for name, _, t0, t1 in self.spans:
            out[name] += (t1 - t0) * 1e-6
        return dict(out)

    def self_ms(self) -> dict:
        """Host ms per name less what the span's child spans cover."""
        return {k: v * 1e-6 for k, v in self._self_ns.items()}


class _Recorded:
    __slots__ = ("rec", "name", "t0")

    def __init__(self, rec: Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        self.rec._open.append([self.name, 0])
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        rec = self.rec
        _, children = rec._open.pop()
        parent = rec._open[-1] if rec._open else None
        if parent is not None:
            parent[1] += t1 - self.t0
        rec._self_ns[self.name] += t1 - self.t0 - children
        rec.spans.append((self.name, parent and parent[0], self.t0, t1))
        return False


def span(name: str):
    """A context manager over one layer's work: the shared ``NULL`` when
    neither a profiler nor ``recording()`` is on."""
    rec = _active
    if rec is not None:
        return _Recorded(rec, name)
    # read through the module on every call: torch rebinds the flag
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return NULL


@contextlib.contextmanager
def recording():
    """Turns the in-memory recorder on for the block and yields it."""
    global _active
    prev, rec = _active, Recorder()
    _active = rec
    try:
        yield rec
    finally:
        _active = prev
