"""Share (%) of the bytes bound (``bench_port/flops.py::render_bytes``
over 3.35 TB/s) in the device time of every launch of the render kernel
``raster_kernel<true>`` in the profiled train (kernel times from the trace by name; the
env count of a launch is its grid.y)."""
from bench_port.harness.traced import render_roofline

KERNEL = "raster_kernel<true>"


def read(ctx):
    if ctx.get("entry") != "train":
        return None
    six = KERNEL.endswith("<true>")
    return render_roofline(
        ctx["trace"], KERNEL, 6 if six else 3, ctx["width"],
        ctx["n_vehicles"] if six else 0, ctx["n_walkers"] if six else 0,
        ctx["n_lights"] if six else 0)
