"""Device time of the optimizer per step: the kernels launched inside the
benchmark's ranges around the program's gradient clip and AdamW update
(``launch.steps``), over the traced slice's steps, in ms."""


def read(rec):
    prof, n = rec.get("profile") or {}, rec.get("trace_steps")
    if not n or not prof.get("range_kernels", {}).get("optimizer"):
        return None
    return prof["range_s"]["optimizer"] / n * 1e3
