# -*- coding: utf-8 -*-
"""Column tables: the port's stand-in for the pandas DataFrames of the data path.

The JAX data path keeps its tile indices and statistics in pandas DataFrames
read from feather files. The GPU machine may lack pandas and pyarrow, so the
port keeps them in :class:`Table`, a dict of equal-length numpy columns with
the few operations the data path uses: a boolean filter
(``climsr_tpu/data/datamodule.py:51-54``), :meth:`Table.concat`, the inner
merge on key columns (``:84-86``), row access and a keyed lookup (pandas'
``set_index(...).at[...]`` / ``.loc[...]``).

:func:`read_feather` and :func:`write_feather` are the port's only pandas
users: they import it inside the call and convert. :func:`as_table` converts
a DataFrame handed to a port entry point where it enters.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np


def _column(values: Sequence[Any]) -> np.ndarray:
    arr = np.asarray(values)
    if arr.dtype.kind == "U":  # strings as python objects, as pandas holds them
        arr = arr.astype(object)
    return arr


class Table:
    """Equal-length named numpy columns, in insertion order."""

    def __init__(self, columns: Optional[Dict[str, Any]] = None):
        self._cols: Dict[str, np.ndarray] = {k: _column(v) for k, v in (columns or {}).items()}
        lengths = {len(v) for v in self._cols.values()}
        if len(lengths) > 1:
            raise ValueError(f"columns of unequal length: { {k: len(v) for k, v in self._cols.items()} }")

    @classmethod
    def from_rows(cls, rows: Iterable[Dict[str, Any]]) -> "Table":
        rows = list(rows)
        names: List[str] = []
        for row in rows:
            names.extend(k for k in row if k not in names)
        return cls({k: [row.get(k) for row in rows] for k in names})

    @property
    def columns(self) -> List[str]:
        return list(self._cols)

    def __len__(self) -> int:
        return len(next(iter(self._cols.values()))) if self._cols else 0

    def __getitem__(self, name: str) -> np.ndarray:
        return self._cols[name]

    def row(self, index: int) -> Dict[str, Any]:
        return {k: v[index] for k, v in self._cols.items()}

    def rows(self) -> Iterator[Dict[str, Any]]:
        for i in range(len(self)):
            yield self.row(i)

    def filter(self, keep: np.ndarray) -> "Table":
        keep = np.asarray(keep, bool)
        return Table({k: v[keep] for k, v in self._cols.items()})

    def isin(self, name: str, values: Iterable[Any]) -> np.ndarray:
        allowed = set(values)
        return np.fromiter((v in allowed for v in self._cols[name]), bool, len(self))

    def drop(self, names: Iterable[str]) -> "Table":
        names = set([names] if isinstance(names, str) else names)
        return Table({k: v for k, v in self._cols.items() if k not in names})

    def with_column(self, name: str, values: Any) -> "Table":
        cols = dict(self._cols)
        cols[name] = np.broadcast_to(np.asarray(values), (len(self),)).copy() if np.ndim(values) == 0 else values
        return Table(cols)

    def lookup(self, key: str, value: Any, column: str) -> Any:
        """``column`` of the first row whose ``key`` equals ``value`` (pandas'
        ``set_index(key).at[value, column]``); KeyError where there is none."""
        hits = np.flatnonzero(self._cols[key] == value)
        if not len(hits):
            raise KeyError(f"{key}={value!r}")
        return self._cols[column][hits[0]]

    @staticmethod
    def concat(tables: Sequence["Table"]) -> "Table":
        """Rows of ``tables`` in order (``pd.concat``); the columns of the first."""
        names = tables[0].columns
        return Table({k: np.concatenate([t[k] for t in tables]) for k in names})

    def merge(self, other: "Table", on: Sequence[str]) -> "Table":
        """The inner join on ``on`` (``pd.merge(self, other, how="inner", on=on)``):
        left rows in order, each followed by its matches in ``other``'s order;
        ``self``'s columns, then ``other``'s that are not keys."""
        clash = (set(self.columns) & set(other.columns)) - set(on)
        if clash:
            raise ValueError(f"merge: columns {sorted(clash)} are on both sides and not keys")
        index: Dict[tuple, List[int]] = {}
        right_keys = zip(*(other[k].tolist() for k in on))
        for j, key in enumerate(right_keys):
            index.setdefault(key, []).append(j)
        left_rows, right_rows = [], []
        for i, key in enumerate(zip(*(self[k].tolist() for k in on))):
            for j in index.get(key, ()):
                left_rows.append(i)
                right_rows.append(j)
        li, ri = np.asarray(left_rows, np.int64), np.asarray(right_rows, np.int64)
        cols = {k: v[li] for k, v in self._cols.items()}
        cols.update({k: v[ri] for k, v in other._cols.items() if k not in on})
        return Table(cols)


def as_table(obj: Any) -> Table:
    """A :class:`Table` as is; a pandas DataFrame (or anything with ``columns``
    and column access) converted column by column."""
    if isinstance(obj, Table):
        return obj
    if hasattr(obj, "columns") and hasattr(obj, "__getitem__"):
        return Table({str(c): np.asarray(obj[c]) for c in obj.columns})
    raise TypeError(f"expected a Table or a DataFrame, got {type(obj).__name__}")


def read_feather(path) -> Table:
    """A feather file as a :class:`Table`. Needs pandas (and pyarrow)."""
    try:
        import pandas as pd
    except ImportError as e:
        raise ImportError(f"reading {path} needs pandas, which is not installed: {e}") from e
    return as_table(pd.read_feather(path))


def write_feather(table: Table, path) -> None:
    """Write ``table`` as a feather file, as pandas' ``to_feather``. Needs pandas (and pyarrow)."""
    try:
        import pandas as pd
    except ImportError as e:
        raise ImportError(f"writing {path} needs pandas, which is not installed: {e}") from e
    pd.DataFrame({k: table[k] for k in table.columns}).reset_index(drop=True).to_feather(path)
