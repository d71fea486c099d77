"""Bursts of ``burst_images`` requests, all due within ``burst_spread_s``,
the bursts arriving as a Poisson process whose mean image rate is
``rate_per_s`` (the count of bursts in a span fixed, the gaps shuffled by
the seed), through ``openloop``."""

from __future__ import annotations

import numpy as np

import openloop


def schedule(traffic, start, span, rng):
    size = traffic["burst_images"]
    bursts = openloop.arrivals(round(traffic["rate_per_s"] * span / size),
                               span, rng)
    within = traffic["burst_spread_s"] * (np.arange(size) + 0.5) / size
    return start + np.sort((bursts[:, None] + within[None, :]).ravel())


inputs = openloop.inputs


def run(cell):
    return openloop.run(cell, schedule)
