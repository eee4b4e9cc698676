"""WDGAIL critic: port of ``gail_carla_tpu/models/discriminator.py``
(``algo/wdgail.py:18-98``). D(obs, metrics, action) through the same
CNN/metrics processors as the policy, then Linear(hidden=100) ->
LeakyReLU(0.2) -> Linear(1).

The mixup gradient penalty takes the gradient w.r.t. the image input only
(the reference keeps ``grad(...)[0]``) on alpha-mixed expert/policy
triples: penalty lambda * (||g||_2 - 1)^2, the norm without an epsilon.
The reference cannot take the penalty on (B, D) state vectors
(``STATE_OBS_ERROR``), and neither does the port.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from gail_carla_tpu_torch.config import ModelConfig
from gail_carla_tpu_torch.models.processors import MetricsEncoder, ObsEncoder

# The reference's penalty draws alpha as (B, 1, 1, 1)
# (gail_carla_tpu/models/discriminator.py:57-58): on a (B, D) state obs
# the mix broadcasts to (B, 1, B, D), and flax's critic then fails inside
# disc_update; only algo="ppo" trains on state obs there.
STATE_OBS_ERROR = (
    "the WDGAIL critic does not train on obs_mode='state': the reference's "
    "gradient penalty mixes a (B, D) state obs with a (B, 1, 1, 1) alpha "
    "into a 4-D tensor its critic cannot take, so it fails; train state "
    "obs with algo='ppo'"
)


class DiscriminatorNet(nn.Module):
    def __init__(self, cfg: ModelConfig, obs_shape=(3, 192, 192),
                 n_actions: int = 2):
        super().__init__()
        self.cfg = cfg
        self.obs_enc = ObsEncoder(cfg, obs_shape)
        self.met_enc = MetricsEncoder(cfg)
        d = self.obs_enc.out_dim + 5 + cfg.cmd_embed_dim + n_actions
        self.hidden = nn.Linear(d, cfg.disc_hidden)
        self.out = nn.Linear(cfg.disc_hidden, 1)

    def forward(self, obs, metrics, action):
        x = torch.cat([self.obs_enc(obs), self.met_enc(metrics), action],
                      dim=1)
        x = F.leaky_relu(self.hidden(x), self.cfg.leaky_slope)
        return self.out(x)[:, 0]


def predict_reward(net: DiscriminatorNet, obs, metrics, action):
    """r = -log(1 - sigmoid(D)) == softplus(D) (wdgail.py:181-189)."""
    return F.softplus(net(obs, metrics, action))


def grad_penalty(net: DiscriminatorNet, expert, policy,
                 lambda_: float = 10.0,
                 alpha: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None):
    """``expert``/``policy`` are (obs, metrics, action) triples; one alpha
    per sample, (B, 1, 1, 1), mixes all three, but only the obs gradient is
    penalised. The penalty's graph is kept, so its backward pass
    differentiates the obs gradient (a double backward through the convs).
    ``alpha`` is drawn from ``generator`` when not given."""
    e_obs, e_met, e_act = expert
    p_obs, p_met, p_act = policy
    if e_obs.dim() == 2:
        raise NotImplementedError(STATE_OBS_ERROR)
    if alpha is None:
        alpha = torch.rand((e_obs.shape[0], 1, 1, 1), generator=generator,
                           device=e_obs.device)
    mix_obs = (alpha * e_obs + (1 - alpha) * p_obs).requires_grad_(True)
    a2 = alpha[:, :, 0, 0]
    mix_met = a2 * e_met + (1 - a2) * p_met
    mix_act = a2 * e_act + (1 - a2) * p_act
    d = net(mix_obs, mix_met, mix_act)
    (g,) = torch.autograd.grad(d.sum(), mix_obs, create_graph=True)
    # g comes back channels-last from the encoder: a norm over its dims
    # reads it in place, where a flatten would copy it
    norm = torch.linalg.vector_norm(g, dim=(1, 2, 3))
    return lambda_ * torch.mean((norm - 1.0) ** 2)


def wd_loss(net: DiscriminatorNet, expert, policy):
    """The -(E[tanh D_e] - E[tanh D_p]) building block
    (wdgail.py:124-131). Returns (wd, mean raw D_e, mean raw D_p)."""
    d_e = net(*expert)
    d_p = net(*policy)
    wd = torch.mean(torch.tanh(d_e)) - torch.mean(torch.tanh(d_p))
    return wd, torch.mean(d_e), torch.mean(d_p)
