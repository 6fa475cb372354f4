"""A reference module that re-exports portbench/reference/model.py and
records each call of its contract with the harness function that made it
(test_pb_reference.py names it in a configuration's ``reference``)."""

import os
import sys

from portbench.reference import model as _model

# (contract function, file of the caller, caller) of each call
CALLS = []

_SKIP = (os.path.abspath(__file__),
         os.path.abspath(os.path.join(os.path.dirname(_model.__file__),
                                      "__init__.py")))


def _record(name):
    frame = sys._getframe(2)
    while os.path.abspath(frame.f_code.co_filename) in _SKIP:
        frame = frame.f_back
    CALLS.append((name, os.path.basename(frame.f_code.co_filename),
                  frame.f_code.co_name))


def build(kind, n_classes, width, depth):
    _record("build")
    return _model.build(kind, n_classes, width, depth)


def calibrate_bn(model, x):
    _record("calibrate_bn")
    return _model.calibrate_bn(model, x)


def precision(model, mode):
    _record("precision")
    return _model.precision(model, mode)


def model_input(kind, images):
    _record("model_input")
    return _model.model_input(kind, images)


def loss(kind, out, labels):
    _record("loss")
    return _model.loss(kind, out, labels)
