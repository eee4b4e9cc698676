"""Operations and bytes of the work a cell's algorithm needs, from shapes
alone, whatever implements it: the policy's and the critic's image layers
and matrix products per row (the configuration's nets module counts
them, ``bench_port/nets/``), the whole training update and rollout
chunk, and the bytes of one BEV render. Peaks of one NVIDIA H100 SXM
(the data sheet, dense): 989 TFLOP/s bf16, 3.35 TB/s of HBM."""
from __future__ import annotations

from bench_port.nets import of

PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12


def net_layers(model: dict, obs_shape, critic: bool):
    """(FLOPs of each layer that sees the image, FLOPs of each dense
    layer) of one row forward, by the configuration's nets module."""
    return of(model).net_layers(model, obs_shape, critic)


def forward(model, obs_shape, critic: bool) -> int:
    convs, dense = net_layers(model, obs_shape, critic)
    return sum(convs) + sum(dense)


def train_row(model, obs_shape, critic: bool) -> int:
    """Forward and backward of one row: the backward computes each layer's
    weight gradient and its input gradient, except the image's."""
    convs, _ = net_layers(model, obs_shape, critic)
    return 3 * forward(model, obs_shape, critic) - convs[0]


def penalty_row(model, obs_shape) -> int:
    """The critic's gradient penalty on one mixed row: the forward, the
    gradient to the image through every layer, and the backward of that
    gradient (to the weights and through the layers again)."""
    return 4 * forward(model, obs_shape, True)


def update_flops(model, obs_shape, n_envs, steps, expert_rows, gail_batch,
                 critic_epochs, ppo_epoch, mini_batch) -> int:
    """One WDGAIL update: the rollout's act (each step and the bootstrap),
    the critic's validation before and after its epochs (expert and
    policy rows), its epochs (expert and policy rows forward and backward,
    the penalty on as many mixed rows), the relabel, and PPO."""
    fp = forward(model, obs_shape, False)
    fc = forward(model, obs_shape, True)
    total = n_envs * steps
    n_disc = min(expert_rows, total) // gail_batch
    disc = critic_epochs * n_disc * gail_batch * (
        2 * train_row(model, obs_shape, True) + penalty_row(model, obs_shape))
    ppo = ppo_epoch * (total // mini_batch) * mini_batch * train_row(
        model, obs_shape, False)
    return ((steps + 1) * n_envs * fp + 2 * 2 * expert_rows * fc + disc
            + total * fc + ppo)


def chunk_flops(model, obs_shape, n_envs, steps) -> int:
    """One rollout chunk: the act at each step and the bootstrap."""
    return (steps + 1) * n_envs * forward(model, obs_shape, False)


def render_bytes(n_envs, channels, width, n_vehicles=0, n_walkers=0,
                 n_lights=0) -> int:
    """Bytes one render of ``n_envs`` must move: the float32 image written
    once, and per env its pose's cos and sin, four indices, the actors'
    poses and their cos and sin, and the lights' values read once. The
    scene's tables (about a megabyte, read in part) are left out, so the
    bound is a little low and a share of it never too high."""
    out = n_envs * channels * width * width * 4
    per_env = (2 + 4) * 4 + (n_vehicles + n_walkers) * (3 + 2) * 4 \
        + n_lights * 4
    return out + n_envs * per_env


def roofline_share(bound_s: float, kernel_s: float):
    """Share (%) of the least time in the time taken; None if nothing ran."""
    if kernel_s <= 0:
        return None
    return 100.0 * bound_s / kernel_s
