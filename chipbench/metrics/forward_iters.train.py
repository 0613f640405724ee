"""Broyden iterations per forward solve (the step's ``deq_steps``), mean
over the window's steps.  DEQ cells only."""


def read(rec):
    its = [n for n in rec.get("iters", []) if n is not None]
    return sum(its) / len(its) if its else None
