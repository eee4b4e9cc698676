"""ms of one ``algo/rollout.py::collect_rollout`` of the update (its steps
and the bootstrap), timed alone after the window (host clock,
synchronised)."""


def read(ctx):
    if ctx.get("entry") != "train":
        return None
    return 1e3 * ctx["phases"]["rollout"]
