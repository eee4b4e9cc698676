"""ms of one ``algo/ppo.py::ppo_update`` at the cell's size, timed alone
after the window (host clock, synchronised)."""


def read(ctx):
    if ctx.get("entry") != "train":
        return None
    return 1e3 * ctx["phases"]["ppo"]
