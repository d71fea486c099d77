"""Faults planted in the timed path, where it produces its answers: the
program's engine wrapped so that each batch's probabilities are spoiled
as they come out.  The check has to read every one of them as not
correct (``tests/test_bench_faults.py`` on the CPU, ``control.py
--fault`` at a cell's own size on the card)."""

from __future__ import annotations

import types

import program


class Broken:
    """The engine with its answers spoiled as they are produced."""

    def __init__(self, engine, fault):
        self._engine, self._fault = engine, fault

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def run(self, inputs, extract=()):
        out = self._engine.run(inputs, extract)
        name = self._engine.graph.outputs[0]
        out[name] = self._fault(out[name].clone())
        return out

    def __call__(self, x):
        return self.run(x)[self._engine.graph.outputs[0]]


def half_left_out(p):
    """The later half of the batch (at least one image) never computed."""
    p[len(p) // 2:] = 0
    return p


def answer_altered(p):
    """The first answer of every batch changed: its classes reversed."""
    p[0] = p[0].flip(-1)
    return p


FAULTS = {f.__name__: f for f in (half_left_out, answer_altered)}


def broken_program(fault):
    """A stand-in for ``program`` whose engines carry ``fault``."""
    return types.SimpleNamespace(
        build_engine=lambda *a: Broken(program.build_engine(*a), fault),
        make_server=program.make_server)
