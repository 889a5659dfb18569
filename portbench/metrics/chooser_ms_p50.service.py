"""Median of the daemon's own per-decision chooser time
(``Daemon.decision_latencies``), in ms: the chooser alone, without the
journal."""
import numpy as np


def read(rec):
    if rec["kind"] != "stream" or not rec["chooser_s"]:
        return None
    return 1e3 * float(np.median(rec["chooser_s"]))
