"""K3 (pool kernel) launches a schedule, from the program's counters."""


def read(rec):
    if rec["kind"] != "backlog":
        return None
    return rec["launches"]["pool"] / rec["units"]
