"""Feature scaling for the surrogate pipeline (NumPy only: a copy of the JAX
package's ``ml/scaling.py``, so that the port imports nothing of it).

Reimplements the two input-scaling regimes of the reference CNN scripts:
per-array max normalization (CNN_One..Three, ``CNNOne_192/CNN_One.py:44-48``)
and a MinMax scaler with a configurable feature range (CNN_Four onwards,
``CNNEight_384/CNN_Eight.py:27-33,55-61``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class MinMaxScaler:
    """Fit/transform/inverse like sklearn's, on flat value ranges."""

    feature_range: Tuple[float, float] = (0.0, 1.0)
    data_min: float = 0.0
    data_max: float = 1.0
    fitted: bool = False

    def fit(self, a: np.ndarray) -> "MinMaxScaler":
        self.data_min = float(np.min(a))
        self.data_max = float(np.max(a))
        self.fitted = True
        return self

    def _scale(self) -> float:
        lo, hi = self.feature_range
        span = self.data_max - self.data_min
        return (hi - lo) / span if span else 1.0

    def transform(self, a: np.ndarray) -> np.ndarray:
        lo, _ = self.feature_range
        return lo + (np.asarray(a) - self.data_min) * self._scale()

    def fit_transform(self, a: np.ndarray) -> np.ndarray:
        return self.fit(a).transform(a)

    def inverse_transform(self, a: np.ndarray) -> np.ndarray:
        lo, _ = self.feature_range
        return (np.asarray(a) - lo) / self._scale() + self.data_min

    def to_dict(self) -> dict:
        return {
            "feature_range": list(self.feature_range),
            "data_min": self.data_min,
            "data_max": self.data_max,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "MinMaxScaler":
        s = cls(feature_range=tuple(d["feature_range"]),
                data_min=d["data_min"], data_max=d["data_max"])
        s.fitted = True
        return s


@dataclasses.dataclass
class MaxScaler:
    """Early-variant scaling: divide by the array's max |value|."""

    scale: float = 1.0
    fitted: bool = False

    def fit(self, a: np.ndarray) -> "MaxScaler":
        self.scale = float(np.max(np.abs(a))) or 1.0
        self.fitted = True
        return self

    def transform(self, a: np.ndarray) -> np.ndarray:
        return np.asarray(a) / self.scale

    def fit_transform(self, a: np.ndarray) -> np.ndarray:
        return self.fit(a).transform(a)

    def inverse_transform(self, a: np.ndarray) -> np.ndarray:
        return np.asarray(a) * self.scale

    def to_dict(self) -> dict:
        return {"scale": self.scale}

    @classmethod
    def from_dict(cls, d: dict) -> "MaxScaler":
        s = cls(scale=d["scale"])
        s.fitted = True
        return s
