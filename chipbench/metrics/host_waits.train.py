"""Host waits on the card per step over the window: explicit synchronize
calls and the implicit ones the sync-debug mode reports (reads of card
tensors: the solver's stop tests, the trainer's one metrics read)."""


def read(rec):
    if rec.get("host_waits") is None or not rec.get("n_steps"):
        return None
    return rec["host_waits"] / rec["n_steps"]
