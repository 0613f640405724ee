"""The program's ``forward_solve`` phase per step (``obs.tracing``, closed
by a CUDA event on the fixed point): from the train step's start (batch
embedding included) to the forward solve's fixed point, mean over the
window's steps, in ms.  DEQ cells only."""


def read(rec):
    ms = rec.get("phases", {}).get("forward_solve")
    return sum(ms) / len(ms) if ms else None
