"""CSV tables as pandas reads and writes them, without pandas.

The JAX package's tools read ``coordinates.csv`` with ``pd.read_csv``
and write it back with ``DataFrame.to_csv(index=False)``; the port's
tools do the same through the :mod:`csv` module with pandas' column
typing reproduced, so the files they write are byte-equal:

- reading: a cell in pandas' default NA set is missing; a column whose
  other cells all parse as integers is int64 (float64 when a cell is
  missing), as numbers float64 (read as pandas' C parser reads them,
  :func:`pandas_float`), as True/False bool (text when a cell is
  missing), else text;
- writing: int64 as integers, float64 as ``repr`` floats (``1.0``,
  ``1e-05``) and missing cells empty, bool as ``True``/``False``, text
  as it is; minimal quoting and ``\\n`` line endings, as pandas writes
  through the csv module.

A column is a (kind, values) pair: kind 'int', 'float', 'bool' or
'object', values Python ints, floats (``nan`` for missing), bools, or
strings (None for missing).
"""

from __future__ import annotations

import csv
import math
from typing import Dict, List, Sequence, Tuple

#: pandas' default NA strings (``pandas.read_csv``'s ``na_values``)
NA_VALUES = frozenset({
    '', '#N/A', '#N/A N/A', '#NA', '-1.#IND', '-1.#QNAN', '-NaN', '-nan',
    '1.#IND', '1.#QNAN', '<NA>', 'N/A', 'NA', 'NULL', 'NaN', 'None', 'n/a',
    'nan', 'null'})
_TRUE = frozenset({'True', 'TRUE', 'true'})
_FALSE = frozenset({'False', 'FALSE', 'false'})

Column = Tuple[str, List]


_POW10 = [float(f'1e{k}') for k in range(309)]
_INFS = {'inf': math.inf, '+inf': math.inf, 'infinity': math.inf,
         '+infinity': math.inf, '-inf': -math.inf, '-infinity': -math.inf}
_SPACE = ' \t\n\v\f\r'


def pandas_float(cell: str) -> float:
    """A float cell as pandas' default C parser reads it
    (``precise_xstrtod``: at most 17 digits, a leading zero among them,
    accumulated in a double and scaled by one power of ten; so
    '0.30000000000000004' reads as 0.3), or ValueError."""
    special = _INFS.get(cell.strip(_SPACE).lower())
    if special is not None:
        return special
    p, n = 0, len(cell)
    while p < n and cell[p] in _SPACE:
        p += 1
    negative = p < n and cell[p] == '-'
    if p < n and cell[p] in '+-':
        p += 1
    number, exponent, digits, decimals = 0.0, 0, 0, 0
    while p < n and '0' <= cell[p] <= '9':
        if digits < 17:
            number = number * 10.0 + (ord(cell[p]) - 48)
            digits += 1
        else:
            exponent += 1
        p += 1
    if p < n and cell[p] == '.':
        p += 1
        while digits < 17 and p < n and '0' <= cell[p] <= '9':
            number = number * 10.0 + (ord(cell[p]) - 48)
            p += 1
            digits += 1
            decimals += 1
        if digits >= 17:
            while p < n and '0' <= cell[p] <= '9':
                p += 1
        exponent -= decimals
    if digits == 0:
        raise ValueError(f"not a float: {cell!r}")
    if negative:
        number = -number
    if p < n and cell[p] in 'eE':
        q = p + 1
        neg_exp = q < n and cell[q] == '-'
        if q < n and cell[q] in '+-':
            q += 1
        e, e_digits = 0, 0
        while e_digits < 17 and q < n and '0' <= cell[q] <= '9':
            e = e * 10 + (ord(cell[q]) - 48)
            e_digits += 1
            q += 1
        if e_digits:
            exponent += -e if neg_exp else e
            p = q
    while p < n and cell[p] in _SPACE:
        p += 1
    if p != n or exponent > 308:
        raise ValueError(f"not a float: {cell!r}")
    if exponent > 0:
        number *= _POW10[exponent]
    elif exponent < -616:
        number = 0.0
    elif exponent < -308:
        number = number / _POW10[-308 - exponent] / _POW10[308]
    else:
        number /= _POW10[-exponent]
    return number


def _parse_all(cells: Sequence[str], cast):
    if cast is int and any('_' in c for c in cells):   # Python's literal
        return None
    try:
        return [cast(c) for c in cells]
    except (ValueError, OverflowError):
        return None


def typed_column(cells: Sequence[str]) -> Column:
    """The column pandas makes of ``cells`` (see the module text)."""
    missing = [c in NA_VALUES for c in cells]
    present = [c for c, m in zip(cells, missing) if not m]
    if not present:
        return 'float', [math.nan] * len(cells)
    ints = _parse_all(present, int)
    if ints is not None and not any(missing):
        return 'int', ints
    floats = _parse_all(present, pandas_float) if ints is None else \
        [float(v) for v in ints]
    if floats is not None:
        it = iter(floats)
        return 'float', [math.nan if m else next(it) for m in missing]
    if all(c in _TRUE or c in _FALSE for c in present):
        # with a missing cell pandas keeps the bools in a text column
        return ('object' if any(missing) else 'bool',
                [None if m else c in _TRUE for c, m in zip(cells, missing)])
    return 'object', [None if m else c for c, m in zip(cells, missing)]


def read_csv(path: str, nrows=None) -> Dict[str, Column]:
    """{column name: (kind, values)} of a CSV file with a header row, in
    the file's column order (the first ``nrows`` rows when given)."""
    with open(path, newline='') as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = []
        for row in reader:
            if nrows is not None and len(rows) >= nrows:
                break
            if row:
                rows.append(row)
    return {name: typed_column([r[i] if i < len(r) else '' for r in rows])
            for i, name in enumerate(header)}


def is_missing(value) -> bool:
    return value is None or (isinstance(value, float) and math.isnan(value))


def format_cell(kind: str, value) -> str:
    if is_missing(value):
        return ''
    if kind == 'float':
        return repr(float(value))
    if kind == 'int':
        return str(int(value))
    return str(value)


def write_csv(path: str, columns: Dict[str, Column]) -> None:
    """Write ``columns`` as ``DataFrame.to_csv(path, index=False)``
    does."""
    names = list(columns)
    n = max((len(v) for _, v in columns.values()), default=0)
    with open(path, 'w', newline='') as f:
        w = csv.writer(f, lineterminator='\n')
        w.writerow(names)
        for i in range(n):
            w.writerow([format_cell(*_cell(columns[name], i))
                        for name in names])


def _cell(column: Column, i: int):
    kind, values = column
    return kind, values[i]
