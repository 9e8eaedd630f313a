"""Device operations (kernels, copies, memsets) per DE step in the
profiled sub-window."""


def read(readings):
    p = readings.profile
    if not p or not p["steps"] or not p["n_ops"]:
        return None
    return p["n_ops"] / p["steps"]
