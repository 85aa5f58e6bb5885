"""Holding what a CLI of this package printed to what another run printed.

The scenario and trace CLIs print rows, parity gaps and ledgers as text.  Two
runs of the same arguments on other devices, or the port against the JAX
package, agree in that text but for the last digits of its numbers and the
walls: ``same_text`` compares the text with each number within a relative
tolerance or one unit of its last printed digit, ``without_walls`` drops a
CSV's ``wall_s`` column.
"""

from __future__ import annotations

import csv
import io
import re

_NUM = re.compile(r"nan|-?inf|-?\d+(?:\.\d*)?(?:[eE][-+]?\d+)?")


def _last_digit(s: str) -> float:
    mant, _, exp = s.lower().partition("e")
    decimals = len(mant.split(".")[1]) if "." in mant else 0
    return 10.0 ** ((int(exp) if exp else 0) - decimals)


def same_text(got: str, want: str, rtol: float) -> bool:
    """``got`` reads as ``want`` but for its numbers, each equal to want's,
    within ``rtol`` of it, or within one unit of its last printed digit."""
    if _NUM.split(got) != _NUM.split(want):
        return False
    for g, w in zip(_NUM.findall(got), _NUM.findall(want)):
        if g == w:
            continue
        if "nan" in (g, w) or "inf" in g or "inf" in w:
            return False
        if not abs(float(g) - float(w)) <= max(rtol * abs(float(w)), _last_digit(w)):
            return False
    return True


def without_walls(csv_text: str) -> str:
    """The CSV text with its ``wall_s`` column removed."""
    rows = list(csv.reader(io.StringIO(csv_text)))
    if not rows or "wall_s" not in rows[0]:
        return csv_text
    i = rows[0].index("wall_s")
    out = io.StringIO()
    csv.writer(out, lineterminator="\n").writerows([r[:i] + r[i + 1:] for r in rows])
    return out.getvalue()
