"""Column tables: the port's stand-in for the pandas DataFrames of the JAX
package's ingest code (data/gdsc.py, data/create.py). The card's machine
has no pandas.

A table is an insertion-ordered dict, column name → list of values, every
column of one length. ``read_csv`` types each column as pandas'
``read_csv`` does for the cases the ingest meets: int when every present
value is an int, else float when every present value is a number (a
missing value makes an int column float, NaN in its place), else str
(None in place of a missing value); pandas' default missing-value strings
count as missing. Numbers are parsed as pandas' default C parser parses
them (``parse_float``), which is not correctly rounded: about a third of
17-digit decimals land one unit in the last place away from Python's
``float``.
"""

from __future__ import annotations

import csv
import math
import re
from typing import Dict, Iterable, List, Optional, Sequence

Table = Dict[str, list]

# pandas' default na_values (pandas._libs.parsers.STR_NA_VALUES)
NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})


_INT = re.compile(r"\s*[+-]?\d+\s*\Z")
_INF = {"inf": math.inf, "+inf": math.inf, "-inf": -math.inf,
        "infinity": math.inf, "+infinity": math.inf,
        "-infinity": -math.inf}
_POW10 = [float(f"1e{k}") for k in range(309)]


def parse_float(text: str) -> float:
    """``text`` as pandas' default ``read_csv`` parses a float
    (precise_xstrtod in pandas' tokenizer.c, step for step in double
    arithmetic: at most 17 significant digits accumulated as
    number · 10 + digit, then one multiply or divide by the power of ten);
    ValueError when it is not a number."""
    t = text.strip()
    if t.lower() in _INF:
        return _INF[t.lower()]
    m = re.fullmatch(r"([+-]?)(\d*)(?:\.(\d*))?(?:[eE]([+-]?\d+))?", t)
    if m is None or not (m[2] or m[3]):
        raise ValueError(f"not a number: {text!r}")
    number, exponent, n_digits = 0.0, 0, 0
    for ch in m[2]:
        if n_digits < 17:
            number = number * 10.0 + (ord(ch) - 48)
            n_digits += 1
        else:
            exponent += 1
    for ch in (m[3] or "")[:max(0, 17 - n_digits)]:
        number = number * 10.0 + (ord(ch) - 48)
        n_digits += 1
        exponent -= 1
    if m[1] == "-":
        number = -number
    if m[4]:
        e = m[4].lstrip("+-")[:17]
        exponent += -int(e) if m[4].startswith("-") else int(e)
    if exponent > 308:
        return math.copysign(math.inf, number)
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -308:
        if exponent < -616:
            return math.copysign(0.0, number)
        return number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def _typed(raw: List[str]) -> list:
    present = [v for v in raw if v not in NA_STRINGS]
    if all(_INT.match(v) for v in present):
        if len(present) == len(raw):
            return [int(v) for v in raw]
        return [float(int(v)) if v not in NA_STRINGS else math.nan
                for v in raw]
    try:
        return [parse_float(v) if v not in NA_STRINGS else math.nan
                for v in raw]
    except ValueError:
        return [v if v not in NA_STRINGS else None for v in raw]


def read_csv(path: str, sep: str = ",") -> Table:
    """The file's columns, typed (module docstring)."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f, delimiter=sep))
    if not rows:
        return {}
    header, body = rows[0], rows[1:]
    return {name: _typed([r[j] for r in body])
            for j, name in enumerate(header)}


def is_missing(v) -> bool:
    return v is None or (isinstance(v, float) and math.isnan(v))


def _cell(v) -> str:
    return "" if is_missing(v) else str(v)


def write_csv(table: Table, path: str) -> None:
    """The table as a CSV with a header row (missing values empty; floats
    in their shortest round-trip form, as pandas' ``to_csv`` writes
    them)."""
    cols = list(table)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(cols)
        for row in zip(*(table[c] for c in cols)):
            w.writerow([_cell(v) for v in row])


def n_rows(table: Table) -> int:
    return len(next(iter(table.values()))) if table else 0


def take(table: Table, idx: Iterable[int],
         columns: Optional[Sequence[str]] = None) -> Table:
    """The rows ``idx``, in that order (``df.iloc[idx]``), of ``columns``
    (all by default)."""
    idx = list(idx)
    return {c: [table[c][i] for i in idx] for c in (columns or table)}


def where(table: Table, keep: Sequence[bool],
          columns: Optional[Sequence[str]] = None) -> Table:
    """The rows where ``keep`` holds, in order (``df[mask]``)."""
    return take(table, [i for i, k in enumerate(keep) if k], columns)


def concat(tables: Sequence[Table]) -> Table:
    """The tables' rows one after the other (``pd.concat(...,
    ignore_index=True)`` of tables with the same columns)."""
    return {c: [v for t in tables for v in t[c]] for c in tables[0]}
