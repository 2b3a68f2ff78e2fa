"""CheXpert CSV manifests without pandas (counterpart of the JAX package's
``data/manifest.py``; the port takes on no pandas dependency).

Covers the reference's CSV handling: ``CustomDataset`` label extraction
(``DataRetrieval.py:70-96``: the first column is the image path, the label
columns are the 5 competition tasks as floats) and the
``CSV_reformatting`` utilities (NA handling, frontal filtering,
all-negative-row removal, label-pattern counting).

The CSV is read with the standard ``csv`` module, keeping what
``pd.read_csv`` does where CheXpert CSVs depend on it: an empty cell or one
of pandas' default NA strings reads as NaN, uncertain ``-1.0`` labels stay
as they are, quoted fields are unquoted, and a missing label column raises
``KeyError``.
"""

from __future__ import annotations

import csv
from collections import Counter
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np

from incremental_multimodal_medical_learning_ii_torch.utils.config import (
    CHEXPERT_COMPETITION_TASKS,
)

# pandas' default ``na_values`` (pandas/_libs/parsers.pyx STR_NA_VALUES)
NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
})


def _cell_float(value: str) -> float:
    return float("nan") if value in NA_STRINGS else float(value)


class ChexpertManifest:
    """A CSV of image paths + multi-hot labels: the header and the rows as
    strings, parsed on demand."""

    def __init__(
        self,
        columns: Sequence[str],
        rows: Sequence[Sequence[str]],
        img_dir: str | Path = "",
        label_names: Sequence[str] = CHEXPERT_COMPETITION_TASKS,
    ):
        self.columns = list(columns)
        self.rows = [list(r) for r in rows]
        self.img_dir = str(img_dir)
        self.label_names = list(label_names)

    @classmethod
    def from_csv(
        cls,
        csv_path: str | Path,
        img_dir: str | Path = "",
        label_names: Sequence[str] = CHEXPERT_COMPETITION_TASKS,
    ) -> "ChexpertManifest":
        with open(csv_path, newline="") as f:
            reader = csv.reader(f)
            columns = next(reader)
            rows = [r for r in reader if r]  # pandas skips blank lines
        width = len(columns)
        for i, r in enumerate(rows):
            if len(r) > width:
                raise ValueError(f"{csv_path}: row {i + 2} has {len(r)} fields, expected {width}")
            r.extend([""] * (width - len(r)))  # short rows fill with NaN, as pandas does
        return cls(columns, rows, img_dir, label_names)

    def _derive(self, rows) -> "ChexpertManifest":
        return ChexpertManifest(self.columns, rows, self.img_dir, self.label_names)

    def __len__(self) -> int:
        return len(self.rows)

    def _path_cell(self, row) -> str:
        value = row[0]
        return "nan" if value in NA_STRINGS else value  # str() of pandas' NaN

    def image_path(self, idx: int) -> str:
        # reference: str(img_dir) + str(first CSV column) (DataRetrieval.py:87)
        return self.img_dir + self._path_cell(self.rows[idx])

    def image_paths(self) -> List[str]:
        return [self.img_dir + self._path_cell(r) for r in self.rows]

    def _label_index(self) -> List[int]:
        missing = [n for n in self.label_names if n not in self.columns]
        if missing:
            raise KeyError(f"{missing} not in the manifest's columns")
        return [self.columns.index(n) for n in self.label_names]

    def labels(self) -> np.ndarray:
        cols = self._label_index()
        out = np.empty((len(self.rows), len(cols)), np.float32)
        for i, r in enumerate(self.rows):
            out[i] = [_cell_float(r[c]) for c in cols]
        return out

    # ------------------------------------------------------------------
    # CSV_reformatting equivalents
    # ------------------------------------------------------------------
    def dropna_labels(self) -> "ChexpertManifest":
        """Drop rows with NA in any label column (remove_NA.py:40-51)."""
        cols = self._label_index()
        return self._derive([r for r in self.rows if not any(r[c] in NA_STRINGS for c in cols)])

    def filter_frontal(self, column: str = "Frontal/Lateral", value: str = "Frontal") -> "ChexpertManifest":
        """Keep frontal views only."""
        if column not in self.columns:
            # CheXpert encodes the view in the path when no column exists
            return self._derive([r for r in self.rows if "frontal" in self._path_cell(r).lower()])
        c = self.columns.index(column)
        return self._derive([r for r in self.rows if r[c] == value])

    def remove_all_negative(self) -> "ChexpertManifest":
        """Drop rows whose 5 labels are all zero (new_test_set_senza sani.py);
        a row with a NaN label sums to NaN and goes too, as in pandas."""
        keep = self.labels().sum(axis=1) > 0
        return self._derive([r for r, k in zip(self.rows, keep) if k])

    def label_pattern_counts(self) -> Counter:
        """Frequency of each multi-hot pattern (count_pos_neg_in_csv.py)."""
        return Counter(tuple(int(v) for v in row) for row in self.labels())

    def positive_counts(self) -> np.ndarray:
        return self.labels().sum(axis=0)

    def split(self, first_n: int) -> Tuple["ChexpertManifest", "ChexpertManifest"]:
        """Contiguous head/tail split (splitTrainingEmbedding.py:17-29)."""
        return self._derive(self.rows[:first_n]), self._derive(self.rows[first_n:])
