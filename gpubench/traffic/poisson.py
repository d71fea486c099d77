"""Independent users' single-image requests, arriving as a Poisson process
at ``rate_per_s`` (the count in a span fixed, the gaps shuffled by the
seed), through ``openloop``."""

from __future__ import annotations

import openloop


def schedule(traffic, start, span, rng):
    return start + openloop.arrivals(round(traffic["rate_per_s"] * span),
                                     span, rng)


inputs = openloop.inputs


def run(cell):
    return openloop.run(cell, schedule)
