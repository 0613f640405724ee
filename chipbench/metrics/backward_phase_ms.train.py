"""The program's ``implicit_backward`` phase per step: from the forward
fixed point to the SHINE cotangent ``u = H^T w`` (the head, the loss and
their backward to ``z*``, and the block group evaluated once at ``z*``
under autograd, all lie inside it; the parameters' VJP through the blocks
does not: it follows the phase's end), mean over the window, in ms."""


def read(rec):
    ms = rec.get("phases", {}).get("implicit_backward")
    return sum(ms) / len(ms) if ms else None
