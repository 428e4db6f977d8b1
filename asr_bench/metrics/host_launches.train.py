"""Kernel launches a joint step in the profiled window: the runtime's
launch calls on the host (any launch API, graph launches included)."""


def read(run):
    prof = run.get("profile")
    if run["kind"] != "train" or prof is None or prof.launches == 0:
        return None
    return prof.launches / prof.units
