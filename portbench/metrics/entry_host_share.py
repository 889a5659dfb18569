"""Share of the window (%) the host spent inside the kernel entry points
``pick_orders``, ``score_probes`` and ``tau_stack`` (copies, launches,
waits and their own host work)."""


def read(rec):
    return 100.0 * sum(rec["entry_s"].values()) / rec["window_s"]
