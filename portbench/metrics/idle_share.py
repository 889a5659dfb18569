"""Share of the traced window (%) in which no kernel, copy or set ran on
the card."""


def read(rec):
    if rec["trace_window_s"] is None or rec["trace_window_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["trace_window_s"])
