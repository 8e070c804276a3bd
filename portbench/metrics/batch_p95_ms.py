"""95th percentile (linear between order statistics) of the latencies of
all the window's batches, each from its send to its results on the host."""

import numpy as np


def read(run):
    lat = [c["t1"] - c["t0"] for c in run.calls if not c.get("failed")]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
