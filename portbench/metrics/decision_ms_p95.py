"""The 95th percentile, over every decision of the window, of the time
from the start of the daemon round that takes a job to its ``decided``
entry having been appended to the journal (ms, the benchmark's clock)."""
import numpy as np


def read(rec):
    if rec["kind"] != "stream" or not rec["latencies_s"]:
        return None
    return 1e3 * float(np.percentile(rec["latencies_s"], 95))
