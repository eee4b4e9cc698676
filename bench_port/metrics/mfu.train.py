"""Share (%) of the H100's 989 TFLOP/s bf16 peak in the untraced window:
the policy's and critic's FLOPs that the window's work needs
(``bench_port/flops.py``) over the window's wall time."""


def read(ctx):
    if ctx.get("entry") != "train":
        return None
    return ctx["mfu"]
