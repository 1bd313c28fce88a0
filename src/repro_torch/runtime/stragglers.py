"""Straggler detection across ranks (the port's copy of
``repro.runtime.stragglers``).

The monitor is rank-agnostic logic: it takes (rank, step time) samples.
A rank is flagged when its trailing-window mean exceeds the fleet median
by ``threshold`` x a robust scale (the MAD, floored in absolute and
relative terms, so microsecond noise on a healthy fleet is not
amplified).  The train loop (``runtime/train_loop.py``) records each
rank's step times and gathers them across ranks once per log interval,
not once a step: a collective per step would add a host sync to the step
being measured.  Flagged ranks are candidates for eviction and an elastic
re-plan (``runtime/elastic.py``).
"""
from __future__ import annotations

from collections import defaultdict, deque

import numpy as np


class StragglerMonitor:
    def __init__(self, window: int = 20, threshold: float = 4.0,
                 min_samples: int = 5, min_abs_dev: float = 1e-3,
                 min_rel_dev: float = 0.02):
        """min_abs_dev/min_rel_dev floor the robust scale estimate: on a
        healthy fleet the MAD is ~0 and a bare 1e-9 floor amplifies
        microsecond noise into "stragglers".  A host must now exceed the
        median by threshold x max(1.4826*MAD, min_abs_dev, min_rel_dev*med)
        — i.e. be meaningfully slower in absolute seconds AND relative
        terms before it is flagged."""
        self.window = window
        self.threshold = threshold
        self.min_samples = min_samples
        self.min_abs_dev = min_abs_dev
        self.min_rel_dev = min_rel_dev
        self._times = defaultdict(lambda: deque(maxlen=window))

    def record(self, host_id, step_time: float):
        self._times[host_id].append(step_time)

    def host_means(self):
        return {h: float(np.mean(t)) for h, t in self._times.items()
                if len(t) >= self.min_samples}

    def stragglers(self):
        means = self.host_means()
        if len(means) < 2:
            return []
        vals = np.array(list(means.values()))
        med = np.median(vals)
        mad = np.median(np.abs(vals - med))
        scale = max(1.4826 * mad, self.min_abs_dev, self.min_rel_dev * med)
        return [h for h, m in means.items()
                if (m - med) / scale > self.threshold]
