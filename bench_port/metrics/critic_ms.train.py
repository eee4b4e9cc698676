"""ms of one critic epoch (``algo/wdgail.py::disc_update``) and the
reward relabel (``relabel_rewards``) at the cell's size, timed alone after
the window (host clock, synchronised)."""


def read(ctx):
    if ctx.get("entry") != "train":
        return None
    return 1e3 * (ctx["phases"]["critic_epoch"] + ctx["phases"]["relabel"])
