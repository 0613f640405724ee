"""The quasi-Newton kernels' share of their roofline: the bound of every
``ops.broyden_step`` and ``ops.qn_apply_multi`` call in the traced slice
(bytes and operations from the call's shapes and live ring slots) over
the device time of the kernels launched inside those calls, in %."""


def read(rec):
    k = rec.get("kernels", {}).get("qn")
    if not k or not k["device_s"]:
        return None
    return k["bound_s"] / k["device_s"] * 100.0
