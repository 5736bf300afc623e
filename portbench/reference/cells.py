"""What the plain reference says a result column holds, row by row.

A reference module returns, for each column of a result, either
:class:`Cells` (each value is ``prefix + decimal(int)``, zero filled to
``width`` digits when ``width`` > 0) or :class:`Hashes` (the 32-bit
FNV-1a of each value's bytes, for values of no such form).  The
comparison (:mod:`portbench.check`) reads the program's output in the
same terms and counts the cells that differ.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Cells:
    """Per row: the value ``prefix + decimal(ints[i])`` (``width`` > 0:
    exactly that many digits, zero filled)."""

    prefix: bytes
    ints: np.ndarray
    width: int = 0

    def __len__(self) -> int:
        return int(self.ints.size)

    def take(self, rows: np.ndarray) -> "Cells":
        return Cells(self.prefix, self.ints[rows], self.width)


@dataclass
class Hashes:
    """Per row: the 32-bit FNV-1a of the value's bytes."""

    values: np.ndarray

    def __len__(self) -> int:
        return int(self.values.size)

    def hashes(self) -> np.ndarray:
        return self.values.astype(np.int64)

    def take(self, rows: np.ndarray) -> "Hashes":
        return Hashes(self.values[rows])
