"""The prefill attention kernel's share of its roofline in training: the
bound of every ``ops.attention`` forward call in the traced slice (the
remat's recomputed calls among them) over the device time of the kernels
launched inside those calls, in %."""


def read(rec):
    k = rec.get("kernels", {}).get("attention")
    if not k or not k["device_s"]:
        return None
    return k["bound_s"] / k["device_s"] * 100.0
