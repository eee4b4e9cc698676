"""Training-curve plots from ``metrics.jsonl``, the ``paper_plots/``
equivalent: port of ``gail_carla_tpu/tools/plot_results.py``.

The reference plots TensorBoard CSV exports of the train reward and the
critic's value gaps; this reads the JSONL that ``utils/logging.py::
MetricsWriter`` writes in every run. ``matplotlib`` is imported by
``main``, not with the module.

Usage: python -m gail_carla_tpu_torch.tools.plot_results \\
           --log-dir runs/wdgail [--out plots]
"""
from __future__ import annotations

import argparse
import json
import os


def load_metrics(log_dir: str):
    """The rows of ``log_dir/metrics.jsonl``, in order."""
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


PANELS = [
    ("train reward", ["ep_reward_mean", "eval/reward"]),
    ("discriminator WD (val)", ["disc/pre_val_wd", "disc/post_val_wd"]),
    ("ppo losses", ["ppo/value_loss", "ppo/action_loss"]),
    ("gail reward", ["gail_reward_mean"]),
]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--log-dir", default="runs/wdgail")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = load_metrics(args.log_dir)
    steps = [r["step"] for r in rows]
    fig, axes = plt.subplots(2, 2, figsize=(11, 7))
    for ax, (title, keys) in zip(axes.ravel(), PANELS):
        for k in keys:
            ys = [r.get(k) for r in rows]
            xs = [s for s, y in zip(steps, ys) if y is not None]
            ys = [y for y in ys if y is not None]
            if ys:
                ax.plot(xs, ys, label=k)
        ax.set_title(title)
        ax.set_xlabel("update")
        ax.legend(fontsize=7)
    fig.tight_layout()
    out = args.out or args.log_dir
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "training_curves.png")
    fig.savefig(path, dpi=120)
    plt.close(fig)
    print(path)


if __name__ == "__main__":
    main()
