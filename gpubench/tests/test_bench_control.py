"""The control fails the check: the plain reference in the program's place
at int4, the nearest precision below the configuration's int8, on the
inputs each cell compares, at the cell's own size, on three seeds.  Run on
the card: ``python3 -m pytest gpubench/tests -m card``."""

import pytest

import control

SEEDS = (3000000021, 3000000022, 3000000023)


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
def test_control_is_not_correct(card, bench, seed):
    for wl in bench["workloads"]:
        r = control.readings(bench, wl["name"], seed, card)
        assert any(r[k] > lim for k, lim in r["limits"].items()), r
