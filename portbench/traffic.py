"""The one traffic generator: a mix file of parameters and a seed give the
pool of right-hand sides a run cycles through, and how many solves it
keeps in flight.

A mix (``traffic/<name>.json``) holds:

* ``in_flight``: solves issued and not yet read back (1: each solve's
  stats are read before the next call; k: solve i + k is issued only
  after solve i's stats are read);
* ``pool``: distinct right-hand sides, made once in set-up and cycled;
* ``base_seed``, ``sources``, ``amplitude``, ``width``, ``centre``: the
  Gaussian family (``reference/rhs.py``): [lo, hi] of the sources a
  right-hand side sums, of |a|, of c and of each centre coordinate, drawn
  once from ``base_seed``.

The run's seed changes the order of the work and not its amount: every
seed gets the same set of right-hand sides, each with a sign and in an
order drawn from the seed. The solver's work is odd in b to the last
bit (u(-b) = -u(b), the same V-cycles), while a mirror image of b
already changes the rounding of the f32 corrections enough to change
the number of refines. Generation is never timed.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from portbench.reference.rhs import gaussian_sources

KEYS = ("in_flight", "pool", "base_seed", "sources", "amplitude", "width",
        "centre")


def load(path: Path) -> dict:
    mix = json.loads(Path(path).read_text())
    missing = [k for k in KEYS if k not in mix]
    if missing:
        raise ValueError(f"{path}: traffic mix lacks {missing}")
    if int(mix["in_flight"]) < 1 or int(mix["pool"]) < 1:
        raise ValueError(f"{path}: in_flight and pool must be >= 1")
    return mix


def base_sources(mix: dict) -> list:
    """The mix's set of right-hand sides, one list of (a, c, x0, y0)
    each, drawn from ``base_seed``."""
    rng = np.random.default_rng(int(mix["base_seed"]))
    out = []
    for _ in range(int(mix["pool"])):
        n = int(rng.integers(mix["sources"][0], mix["sources"][1] + 1))
        out.append([(float(rng.choice((-1.0, 1.0)) * rng.uniform(
                         *mix["amplitude"])),
                     float(rng.uniform(*mix["width"])),
                     float(rng.uniform(*mix["centre"])),
                     float(rng.uniform(*mix["centre"])))
                    for _ in range(n)])
    return out


def pool_sources(mix: dict, seed: int) -> list:
    """The run's pool: the mix's set in an order, each right-hand side
    with a sign, drawn from ``seed``."""
    base = base_sources(mix)
    rng = np.random.default_rng(int(seed))
    order = rng.permutation(len(base))
    signs = rng.choice((-1.0, 1.0), size=len(base))
    return [[(s * a, c, x0, y0) for a, c, x0, y0 in base[k]]
            for k, s in zip(order, signs)]


def make_pool(mix: dict, seed: int, side: int, device) -> list:
    """The pool of (side, side) f64 right-hand sides on ``device``."""
    return [gaussian_sources(side, src, device)
            for src in pool_sources(mix, seed)]
