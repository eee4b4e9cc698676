"""Share (%) of the profiled chunk in which no operation ran on the
device (the union of kernel, copy and set intervals of the trace)."""


def read(ctx):
    if ctx.get("entry") != "rollout":
        return None
    t = ctx["trace"]
    return 100.0 * (t["window_s"] - t["busy_s"]) / t["window_s"]
