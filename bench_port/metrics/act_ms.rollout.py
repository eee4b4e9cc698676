"""ms per ``models/policy.py::act`` at the cell's batch, over repeated
calls timed alone after the window (host clock, synchronised)."""


def read(ctx):
    if ctx.get("entry") != "rollout":
        return None
    return 1e3 * ctx["phases"]["act"]
