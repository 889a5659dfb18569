"""Share of the window (%) the host spent outside the kernel entry points
and outside the simulator: the policy, its bisection and the columnar
step's host NumPy."""


def read(rec):
    if rec["kind"] != "backlog":
        return None
    inside = sum(rec["entry_s"].values()) + rec["simulate_s"]
    return 100.0 * (rec["window_s"] - inside) / rec["window_s"]
