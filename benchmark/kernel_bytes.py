"""Bytes a hand kernel's call must move: the roofline's counts.

Copied from the repo's ``chip_smoke.py`` (``band_bytes``) so that a
change to the program cannot change the yardstick.  ``append_band_copy``
writes one [N, C] chunk of both int32 log rings under a bool mask: it
reads the mask once and, for each written element, its two int32 sources,
and writes the two int32 ring slots.
"""

from __future__ import annotations


def band_bytes(elements: int, written: int) -> int:
    """Bytes the masked in-place write-back must move: the mask once, and
    for each written element its two int32 sources read and its two int32
    ring slots written."""
    return elements + written * 16
