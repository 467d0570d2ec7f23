"""Evaluation index entry (counterpart of latentsplat_tpu/evaluation/types.py):
a frozen (context, target) selection of view indices of one scene, as the
evaluation index JSON files hold them."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class IndexEntry:
    context: Tuple[int, ...]
    target: Tuple[int, ...]

    @classmethod
    def from_dict(cls, d: dict) -> "IndexEntry":
        return cls(context=tuple(d["context"]), target=tuple(d["target"]))

    def to_dict(self) -> dict:
        return {"context": list(self.context), "target": list(self.target)}
