"""A small column table: named, equal-length numpy columns.

It covers what the per-detector, layer and region tables need — column
access by attribute or key, positional and boolean row selection,
sorting, concatenation and CSV/JSON round trips — with numpy alone.
"""

from __future__ import annotations

import csv
import json
from types import SimpleNamespace

import numpy as np


class _RowSelector:
    def __init__(self, table: "Table", boolean: bool):
        self._table = table
        self._boolean = boolean

    def __getitem__(self, key):
        if self._boolean:
            return self._table.take(np.flatnonzero(np.asarray(key, dtype=bool)))
        return self._table.take(key)


class Table:
    """Columns in insertion order; every column is a 1-D numpy array of
    the table's length."""

    def __init__(self, columns: dict = None):
        object.__setattr__(self, "_columns", {})
        for name, values in (columns or {}).items():
            self[name] = values

    # -- columns ----------------------------------------------------------------
    @property
    def columns(self) -> list:
        return list(self._columns)

    def __len__(self) -> int:
        return len(next(iter(self._columns.values()))) if self._columns else 0

    def __contains__(self, name) -> bool:
        return name in self._columns

    def __getattr__(self, name):
        columns = self.__dict__.get("_columns", {})
        if name in columns:
            return columns[name]
        raise AttributeError(name)

    def __getitem__(self, key):
        if isinstance(key, str):
            return self._columns[key]
        return Table({name: self._columns[name] for name in key})

    def __setitem__(self, name: str, values):
        values = np.asarray(values)
        if values.ndim == 0:  # a scalar fills the column
            values = np.full(len(self), values.item())
        if values.ndim != 1:
            raise ValueError(f"column '{name}' must be 1-D, got shape {values.shape}")
        if self._columns and name not in self._columns and len(values) != len(self):
            raise ValueError(f"column '{name}' has {len(values)} rows; the table has {len(self)}")
        self._columns[name] = values.copy()

    def insert(self, position: int, name: str, values):
        self[name] = values
        names = [n for n in self._columns if n != name]
        names.insert(position, name)
        object.__setattr__(self, "_columns", {n: self._columns[n] for n in names})

    # -- rows -------------------------------------------------------------------
    @property
    def iloc(self) -> _RowSelector:
        return _RowSelector(self, boolean=False)

    @property
    def loc(self) -> _RowSelector:
        return _RowSelector(self, boolean=True)

    def take(self, index) -> "Table":
        index = np.atleast_1d(np.asarray(index))
        if index.dtype == bool:
            index = np.flatnonzero(index)
        return Table({name: values[index] for name, values in self._columns.items()})

    def sort_values(self, by, ignore_index: bool = True) -> "Table":
        """Stable sort by one or more columns, the first one primary."""
        by = [by] if isinstance(by, str) else list(by)
        return self.take(np.lexsort([self._columns[name] for name in reversed(by)]))

    def reset_index(self, drop: bool = True) -> "Table":
        return self.copy()

    def copy(self) -> "Table":
        return Table(self._columns)

    def iterrows(self):
        names = self.columns
        for i in range(len(self)):
            yield i, SimpleNamespace(**{name: self._columns[name][i] for name in names})

    # -- conversion -------------------------------------------------------------
    def to_dict(self) -> dict:
        return {name: values.tolist() for name, values in self._columns.items()}

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_json(cls, text: str) -> "Table":
        return cls({name: np.asarray(values) for name, values in json.loads(text).items()})

    def __repr__(self):
        return f"Table({len(self)} rows: {', '.join(self.columns)})"


def concat(tables) -> Table:
    """Rows of every table in order; all must share their columns."""
    tables = list(tables)
    names = tables[0].columns
    return Table({name: np.concatenate([t[name] for t in tables]) for name in names})


def _parse(values: list) -> np.ndarray:
    for kind in (int, float):
        try:
            return np.asarray([kind(v) for v in values])
        except ValueError:
            continue
    return np.asarray(values)


def read_csv(path: str) -> Table:
    """A headed CSV file; each column is int, float or str, whichever
    parses every value."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], [r for r in rows[1:] if r]
    return Table({name: _parse([r[i] for r in body]) for i, name in enumerate(header)})
