"""Iteration logger: the solver's fixed-width table (iter, alpha,
inner_crit, prim_err, dual_err, preg, dphi0, merit, ΔM, aliter, mu), the
port of ``aligator_tpu.utils.logger`` with the same columns and formats.
``ProxDDPSettings(verbose=True)`` prints one row per Newton step."""

from __future__ import annotations

import re

COLS = (
    ("iter", "{:>5d}"),
    ("alpha", "{:>9.2e}"),
    ("inner_crit", "{:>10.2e}"),
    ("prim_err", "{:>9.2e}"),
    ("dual_err", "{:>9.2e}"),
    ("preg", "{:>9.2e}"),
    ("dphi0", "{:>10.2e}"),
    ("merit", "{:>11.4e}"),
    ("dM", "{:>10.2e}"),
    ("aliter", "{:>6d}"),
    ("mu", "{:>8.1e}"),
)

_HEAD_EVERY = 25  # the headline is printed again every 25 rows


def print_headline():
    widths = [int(re.search(r">(\d+)", fmt).group(1)) for _, fmt in COLS]
    line = " ".join(f"{name:>{w}s}" for (name, _), w in zip(COLS, widths))
    print(line)
    print("-" * len(line))


def print_row(it, alpha, inner_crit, prim, dual, preg, dphi0, merit, dM, aliter, mu):
    it = int(it)
    if it % _HEAD_EVERY == 0:
        print_headline()
    vals = (it + 1, float(alpha), float(inner_crit), float(prim), float(dual),
            float(preg), float(dphi0), float(merit), float(dM), int(aliter) + 1, float(mu))
    print(" ".join(fmt.format(v) for (_, fmt), v in zip(COLS, vals)))
