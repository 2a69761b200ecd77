"""Slot clocks (common/slot_clock: SlotClock trait src/lib.rs:20,
SystemTimeSlotClock, ManualSlotClock for tests).

All durations in seconds; slots start at genesis_time and last
spec.seconds_per_slot.

A copy of ``lighthouse_tpu/common/slot_clock.py``: the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import time
from typing import Optional


class SlotClock:
    def __init__(self, genesis_time: int, seconds_per_slot: int, genesis_slot: int = 0):
        self.genesis_time = genesis_time
        self.seconds_per_slot = seconds_per_slot
        self.genesis_slot = genesis_slot

    def now(self) -> Optional[int]:
        """Current slot, or None before genesis."""
        t = self._now_seconds()
        if t < self.genesis_time:
            return None
        return self.genesis_slot + int(t - self.genesis_time) // self.seconds_per_slot

    def now_or_genesis(self) -> int:
        return self.now() if self.now() is not None else self.genesis_slot

    def start_of(self, slot: int) -> float:
        return self.genesis_time + (slot - self.genesis_slot) * self.seconds_per_slot

    def seconds_into_slot(self) -> float:
        t = self._now_seconds()
        if t < self.genesis_time:
            return 0.0
        return (t - self.genesis_time) % self.seconds_per_slot

    def duration_to_next_slot(self) -> float:
        return self.seconds_per_slot - self.seconds_into_slot()

    def _now_seconds(self) -> float:
        raise NotImplementedError


class SystemTimeSlotClock(SlotClock):
    def _now_seconds(self) -> float:
        return time.time()


class ManualSlotClock(SlotClock):
    """Test clock: time only moves when told to (ManualSlotClock)."""

    def __init__(self, genesis_time: int, seconds_per_slot: int, genesis_slot: int = 0):
        super().__init__(genesis_time, seconds_per_slot, genesis_slot)
        self._t = float(genesis_time)

    def _now_seconds(self) -> float:
        return self._t

    def set_slot(self, slot: int) -> None:
        self._t = self.start_of(slot)

    def advance_slot(self, n: int = 1) -> None:
        self._t += n * self.seconds_per_slot

    def advance_seconds(self, s: float) -> None:
        self._t += s
