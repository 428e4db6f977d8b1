"""Kernel launches a batch in the profiled window: the runtime's launch
calls on the host (any launch API, graph launches included)."""


def read(run):
    prof = run.get("profile")
    if run["kind"] != "decode" or prof is None or prof.launches == 0:
        return None
    return prof.launches / prof.units
