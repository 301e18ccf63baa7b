#!/usr/bin/env python3
"""The three figures that set a training curve beside the JAX validation.

Reads a curve of ``Extra/Group Reward Mean`` as ``scripts/extract_curves.py``
writes it (``step,value``, or ``step,minutes,value`` with ``--wall-time``)
and gives:

- ``reach_step``: the first decision count at which the trailing 5-point
  rolling mean reaches the level, 25 unless ``--level`` says otherwise
  (None if it never does), with ``reach_minutes``,
  the curve's own minutes column there where it has one;
- ``mean_54_60M``: the mean of the points at 54–60 M decisions, both ends
  included (None if there is none);
- ``tail_mean``: the mean of the last 10 % of the points, at least one
  (``scripts/summarize_matrix.py``'s ``tail_mean``).

For JAX lily seed 1 (``docs/validation/DirGate_lily_seed1__extra_group_
reward_mean.csv``) they are 30.72 M, 29.81 and 35.45; for JAX dandelion
seed 1 at ``--level 2.5`` 21.76 M, 2.75 and 3.02; for JAX cyclamen seed 1
48.64 M, 25.02 and 28.75.

Usage:
    python scripts/validation_figures_torch.py [--level 25] CURVE.csv [CURVE.csv ...]
"""

from __future__ import annotations

import argparse
import csv
import sys
from pathlib import Path

LEVEL = 25.0
WINDOW = 5
SPAN = (54_000_000, 60_000_000)
TAIL = 0.1


def read_curve(path) -> list[tuple[int, float, float | None]]:
    """(step, value, minutes or None) rows, in the file's order."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    return [(int(r["step"]), float(r["value"]),
             float(r["minutes"]) if r.get("minutes") not in (None, "") else None)
            for r in rows]


def reach(rows, level=LEVEL, window=WINDOW):
    """The first row at which the mean of it and the ``window - 1`` rows
    before it is at least ``level``: (step, minutes), or (None, None)."""
    values = [v for _, v, _ in rows]
    for i in range(window - 1, len(rows)):
        if sum(values[i - window + 1:i + 1]) / window >= level:
            return rows[i][0], rows[i][2]
    return None, None


def span_mean(rows, lo=SPAN[0], hi=SPAN[1]):
    values = [v for s, v, _ in rows if lo <= s <= hi]
    return sum(values) / len(values) if values else None


def tail_mean(rows, frac=TAIL):
    k = max(1, int(len(rows) * frac))
    values = [v for _, v, _ in rows[-k:]]
    return sum(values) / len(values)


def figures(rows, level=LEVEL) -> dict:
    step, minutes = reach(rows, level)
    return {"points": len(rows), "last_step": rows[-1][0], "reach_step": step,
            "reach_minutes": minutes, "mean_54_60M": span_mean(rows),
            "tail_mean": tail_mean(rows)}


def _fmt(x, scale=1.0, unit=""):
    return "never" if x is None else f"{x / scale:.2f}{unit}"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("curves", nargs="+")
    p.add_argument("--level", type=float, default=LEVEL,
                   help="the reward the rolling mean is to reach (default %(default)g)")
    args = p.parse_args(argv)
    for path in args.curves:
        f = figures(read_curve(path), args.level)
        print(f"{Path(path).name}: {f['points']} points to {f['last_step'] / 1e6:.2f} M; "
              f"rolling mean reaches {args.level:g} at {_fmt(f['reach_step'], 1e6, ' M')}"
              + (f" ({f['reach_minutes']:.2f} min)" if f["reach_minutes"] is not None else "")
              + f"; 54–60 M mean {_fmt(f['mean_54_60M'])}; tail-10 % mean "
              f"{f['tail_mean']:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
