"""Exact rational scale factors (counterpart of
latentsplat_tpu/misc/fraction_utils.py)."""

from __future__ import annotations

from fractions import Fraction
from typing import Union

Number = Union[int, Fraction]


def get_integer(value: Number) -> int:
    """`value` as an int; raises where it is not a whole number."""
    value = Fraction(value)
    if value.denominator != 1:
        raise ValueError(f"{value} is not an integer")
    return int(value)


def to_fraction(value: Union[str, int, float, Fraction]) -> Fraction:
    return Fraction(value)
