"""Invariant / assertion layer with tiered paranoia levels.

Capability parity with the reference's ``accord.utils.Invariants``
(accord-core/src/main/java/accord/utils/Invariants.java:29-390): checks are grouped by
asymptotic cost so expensive validation (linear/superlinear scans of internal state) can
be switched on in the simulation harness and off in production.  Levels come from the
environment (``ACCORD_PARANOIA``) or are set programmatically by the test harness.
"""
from __future__ import annotations

import enum
import os


class Paranoia(enum.IntEnum):
    NONE = 0
    CONSTANT = 1
    LINEAR = 2
    SUPERLINEAR = 3


def _from_env() -> Paranoia:
    raw = os.environ.get("ACCORD_PARANOIA", "constant").upper()
    try:
        return Paranoia[raw]
    except KeyError:
        return Paranoia.CONSTANT


class InvariantViolation(AssertionError):
    pass


class Invariants:
    """Static holder for the process-wide paranoia level plus check helpers."""

    paranoia: Paranoia = _from_env()

    # -- level queries ------------------------------------------------------
    @classmethod
    def is_paranoid(cls) -> bool:
        return cls.paranoia >= Paranoia.CONSTANT

    @classmethod
    def test_paranoia(cls, level: Paranoia) -> bool:
        return cls.paranoia >= level

    @classmethod
    def debug(cls) -> bool:
        return cls.paranoia >= Paranoia.LINEAR

    @classmethod
    def set_paranoia(cls, level: Paranoia) -> None:
        cls.paranoia = level

    # -- checks -------------------------------------------------------------
    @staticmethod
    def check_state(condition: bool, msg: str = "invariant violated", *args) -> None:
        if not condition:
            raise InvariantViolation(msg % args if args else msg)

    @staticmethod
    def check_argument(condition: bool, msg: str = "illegal argument", *args) -> None:
        if not condition:
            raise ValueError(msg % args if args else msg)

    @staticmethod
    def non_null(obj, msg: str = "unexpected null"):
        if obj is None:
            raise InvariantViolation(msg)
        return obj

    @staticmethod
    def illegal_state(msg: str = "illegal state"):
        raise InvariantViolation(msg)

    @classmethod
    def paranoid(cls, condition_fn, msg: str = "paranoid invariant violated",
                 level: Paranoia = Paranoia.LINEAR) -> None:
        """Run ``condition_fn`` (a thunk, so the check itself is free when off) only if
        the configured paranoia level is >= ``level``."""
        if cls.paranoia >= level and not condition_fn():
            raise InvariantViolation(msg)


check_state = Invariants.check_state
check_argument = Invariants.check_argument
non_null = Invariants.non_null
illegal_state = Invariants.illegal_state
