"""Device clock model with skew (paper §4.6.2).

Devices on a MAN/WAN have unsynchronized clocks.  Anveshak's decisions are
designed so that, as long as the *source* and *sink* clocks agree
(kappa_1 == kappa_n), a constant per-device skew ``sigma_i = kappa_i - kappa_1``
cancels out of every drop and batch comparison.  We model that skew explicitly
so the property tests can verify the cancellation.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass

__all__ = ["Clock", "monotonic"]


def monotonic() -> float:
    """Process-local monotonic clock for *measuring* wall time (benchmark
    and log timings).

    Every host-side timing read in the tree routes through here: simulation
    time comes from the DES, and raw ``time.time()`` reads are flagged by
    the replay-safety analyzer (DET002) because a wall-clock read inside
    decision logic is a determinism leak.  ``perf_counter`` is monotonic
    and unaffected by NTP steps, so elapsed-time deltas are also more
    honest than ``time.time()`` differences.
    """
    return _time.perf_counter()


@dataclass(slots=True)
class Clock:
    """A device clock: reads true (simulation) time plus a fixed skew.

    ``now(t_true)`` is what this device's clock shows when the global
    simulation time is ``t_true``.  Durations measured on a single device are
    skew-free; only absolute timestamps carry the skew.
    """

    skew: float = 0.0

    def now(self, t_true: float) -> float:
        return t_true + self.skew
