"""The share of the traced slice in which no operation ran on the card
(the union of the profiler's kernels, copies and fills), in %."""


def read(rec):
    prof = rec.get("profile") or {}
    if not prof.get("window_s") or not prof.get("kernels"):
        return None
    return (1.0 - prof["busy_s"] / prof["window_s"]) * 100.0
