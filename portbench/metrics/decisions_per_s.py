"""Decisions a second: jobs decided in the window, placed or failed, with
the outcome journaled, over the window's seconds (submissions included)."""


def read(rec):
    if rec["kind"] != "stream":
        return None
    return rec["decisions"] / rec["window_s"]
