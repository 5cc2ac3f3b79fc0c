"""Darknet-format annotation boxes (port of ``repro/data/darknet.py::BBox``).

Each row of the paper's annotation format is ``{label x y w h}``: the
category, the box center and its width/height, all normalized to [0, 1].
The parser, the writer and `build_targets` belong to the training slice.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class BBox:
    label: int
    x: float  # center, normalized
    y: float
    w: float
    h: float

    def validate(self) -> "BBox":
        if not (0 <= self.x <= 1 and 0 <= self.y <= 1 and 0 < self.w <= 1 and 0 < self.h <= 1):
            raise ValueError(f"bbox out of range: {self}")
        if self.label < 0:
            raise ValueError(f"negative label: {self}")
        return self
