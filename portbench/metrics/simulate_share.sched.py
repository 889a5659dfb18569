"""Share of the window (%) spent inside ``simulate``."""


def read(rec):
    if rec["kind"] != "backlog":
        return None
    return 100.0 * rec["simulate_s"] / rec["window_s"]
