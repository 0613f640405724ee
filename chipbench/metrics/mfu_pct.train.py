"""The operations the window's steps need (``chipbench/flops.py``: the
model's products, the DEQ's at the iterations its solves ran; remat's
recompute not counted) over the window's time at the card's bf16 peak,
in %."""


def read(rec):
    if not rec.get("n_steps") or not rec.get("window_s"):
        return None
    return (sum(rec["step_flops"]) / rec["window_s"] / rec["peak_flops"]
            * 100.0)
