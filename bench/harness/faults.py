"""Faults planted under the timed path, for the readings that set a
cell's limits (``bench/control.py``) and the test that sees ``correct``
come out false: each patches the port's ``GradSync`` class for the block.

* :func:`half_batch`: the second half of the ranks' gradients is replaced
  by the first half's before the sync, so the mean is taken over half the
  batch;
* :func:`no_exchange`: the sync's result is thrown away and each rank
  keeps its own gradient, as if no rank heard from another;
* :func:`small_unsynced` and :func:`small_zeroed`: the same confined to
  the vector leaves (the norms' scales, the biases), whose gradients are
  the smallest: each rank keeps its own, or they are zero.

A step that leaves its state unchanged (the optimizer's update a no-op)
reads 1 in the gradient's and the change's gaps by their definition.
"""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(cls, make):
    orig = cls.__dict__["__call__"]
    cls.__call__ = make(orig)
    try:
        yield
    finally:
        cls.__call__ = orig


def half_batch(gradsync_cls):
    def make(orig):
        def call(self, grads, *args, **kwargs):
            for g in grads.values():
                h = g.shape[0] // 2
                g[g.shape[0] - h:] = g[:h]
            return orig(self, grads, *args, **kwargs)
        return call
    return _patched(gradsync_cls, make)


def no_exchange(gradsync_cls):
    def make(orig):
        def call(self, grads, *args, **kwargs):
            out = orig(self, grads, *args, **kwargs)
            return ({n: grads[n] for n in out[0]}, *out[1:])
        return call
    return _patched(gradsync_cls, make)


def _vector(g) -> bool:
    """A vector leaf's gradient, stacked over the ranks: [ranks, n]."""
    return g.ndim == 2


def small_unsynced(gradsync_cls):
    def make(orig):
        def call(self, grads, *args, **kwargs):
            out = orig(self, grads, *args, **kwargs)
            return ({n: grads[n] if _vector(grads[n]) else g
                     for n, g in out[0].items()}, *out[1:])
        return call
    return _patched(gradsync_cls, make)


def small_zeroed(gradsync_cls):
    def make(orig):
        def call(self, grads, *args, **kwargs):
            for g in grads.values():
                if _vector(g):
                    g.zero_()
            return orig(self, grads, *args, **kwargs)
        return call
    return _patched(gradsync_cls, make)


FAULTS = {"half_batch": half_batch, "no_exchange": no_exchange,
          "small_unsynced": small_unsynced, "small_zeroed": small_zeroed}
