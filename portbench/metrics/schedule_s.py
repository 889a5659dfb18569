"""Seconds a schedule: the window over the schedules completed in it (a
schedule is the plan and its simulation)."""


def read(rec):
    if rec["kind"] != "backlog":
        return None
    return rec["window_s"] / rec["units"]
