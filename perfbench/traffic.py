"""The one traffic generator: reads a traffic mix's parameters and gives
the requests a run sends.

A mix (``traffic/<name>.json``) says:

- ``loop``: ``"closed"`` — each client sends its next request once the
  one before has answered;
- ``clients``: how many send at once (1);
- ``input_sets``: how many stored input sets the run makes, each of
  ``shape``, all of the same sizes;
- ``order``: ``"cycle"`` — request ``n`` reads input set
  ``n mod input_sets``, so no request reads the rows the one before it
  read;
- ``shape``: the sizes of one input set, read by the configuration's
  kind (``rows``; or ``batch`` and ``seq``).

The seed changes the data the kinds draw, never the sizes or the order,
so every seed does the same work.
"""

from __future__ import annotations

import itertools
from typing import Iterator

LOOPS = ("closed",)
ORDERS = ("cycle",)


def validate(mix: dict) -> dict:
    """``mix`` if it is a mix this generator can send, else ``ValueError``."""
    if mix.get("loop") not in LOOPS:
        raise ValueError(f"traffic loop must be one of {LOOPS}, got "
                         f"{mix.get('loop')!r}")
    if mix.get("clients") != 1:
        raise ValueError(f"a closed loop here has 1 client, got "
                         f"{mix.get('clients')!r}")
    if mix.get("order") not in ORDERS:
        raise ValueError(f"traffic order must be one of {ORDERS}, got "
                         f"{mix.get('order')!r}")
    n = mix.get("input_sets")
    if not isinstance(n, int) or n < 1:
        raise ValueError(f"input_sets must be a whole number >= 1, got "
                         f"{n!r}")
    if not isinstance(mix.get("shape"), dict) or not mix["shape"]:
        raise ValueError("traffic needs a shape")
    return mix


def input_order(mix: dict) -> Iterator[int]:
    """The input set each request reads, in the order they are sent."""
    return itertools.cycle(range(validate(mix)["input_sets"]))
