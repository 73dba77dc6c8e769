"""The 95th percentile of request latency over every request of the window
(one request: the posterior mean and std at one batch of points, from its
start until the reply is on the host's side of the card)."""

import numpy as np


def read(rec):
    return 1e3 * float(np.percentile([s["end"] - s["start"] for s in rec.steps], 95))
