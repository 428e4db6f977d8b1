"""The profiled window's share in which no operation ran on the card: one
minus the union of device intervals over the window."""


def read(run):
    prof = run.get("profile")
    if run["kind"] != "decode" or prof is None or prof.busy_s <= 0:
        return None
    return 100.0 * (1.0 - prof.busy_s / prof.window_s)
