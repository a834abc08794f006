"""The 95th percentile of the window's step times: the device time
between consecutive step-boundary CUDA events on the stream, so a wait
for the host counts."""

import numpy as np


def read(r):
    if not r.step_ms:
        return None
    return float(np.percentile(np.asarray(r.step_ms, np.float64), 95))
