"""Faults planted in the timed path, for the tests of the comparison and
for portbench/readings.py: each wraps the program's call (a driver's
``wrap``) and breaks what it produces.

* ``half_batch``: half of each batch left out (the rest zero-padded by
  ``Predictor.dispatch``; a train step's loss then over the half kept);
* ``altered``: detection, the answer for the first image of each batch
  (all its served boxes) moved by 32 pixels once its copy has reached the
  host;
* ``unchanged``: training, a step that returns its state unchanged.
"""

from __future__ import annotations

import torch


def half_batch(fn):
    def call(*args):
        if len(args) == 1:                      # dispatch(images)
            return fn(args[0][:args[0].shape[0] // 2])
        state, images, labels = args            # step(state, x, y)
        half = images.shape[0] // 2
        return fn(state, images[:half], labels[:half])
    return call


def altered(fn):
    def dispatch(images):
        out = fn(images)
        if out.event is not None:
            out.event.synchronize()
        with torch.inference_mode():
            out.host[0][0, :, :4] += 32.0
        return out
    return dispatch


def unchanged(fn):
    def step(state, images, labels):
        return state
    return step


FAULTS = {"half_batch": half_batch, "altered": altered,
          "unchanged": unchanged}
