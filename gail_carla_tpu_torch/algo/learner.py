"""The WDGAIL learner: one update = rollout + critic epochs + reward
relabel + GAE + PPO. Port of ``gail_carla_tpu/algo/learner.py``
(``tools/learn.py:89-306`` of the reference).

The whole update runs on the scene's device (the card unless the scene was
built on the CPU); the host loop applies the warm-up epoch count and
carries the ``LearnerState``. The policy and the critic are ``nn.Module``s
that the update changes in place; their optimizer states are plain
tensors. Every draw of an update can be injected through ``UpdateDraws``.
A process group, where the JAX package takes an ``axis_name``, makes the
update data-parallel over its ranks (``parallel/mesh.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence, Tuple

import torch

from gail_carla_tpu_torch.algo import ppo as ppo_mod
from gail_carla_tpu_torch.algo import wdgail as wdgail_mod
from gail_carla_tpu_torch.algo.buffers import ExpertBuffer
from gail_carla_tpu_torch.algo.optim import AdamState
from gail_carla_tpu_torch.algo.rollout import collect_rollout
from gail_carla_tpu_torch.config import EnvConfig, ModelConfig, TrainConfig
from gail_carla_tpu_torch.convert import (
    critic_from_flax, init_critic_flax_params, init_flax_params,
    policy_from_flax,
)
from gail_carla_tpu_torch.models.discriminator import (
    STATE_OBS_ERROR, DiscriminatorNet,
)
from gail_carla_tpu_torch.models.policy import PolicyNet
from gail_carla_tpu_torch.ops.gae import compute_returns
from gail_carla_tpu_torch.ops.state_obs import STATE_OBS_DIM
from gail_carla_tpu_torch.parallel.collectives import all_mean
from gail_carla_tpu_torch.sim.env import (
    RenderState, ResetDraws, StepDraws, reset_batch,
)
from gail_carla_tpu_torch.utils import running_mean_std as rms_mod
from gail_carla_tpu_torch.utils.trace import span


@dataclasses.dataclass
class LearnerState:
    policy: PolicyNet
    policy_opt: AdamState
    disc: DiscriminatorNet
    disc_opt: AdamState
    env_states: object
    metrics: torch.Tensor
    render: RenderState
    gail_gamma: torch.Tensor     # () f32, BCGAIL weight, decays per update
    generator: torch.Generator   # draws whatever an update is not given
    update_i: int
    reward_rms: rms_mod.RunningMeanStd   # of the DISCOUNTED gail return
    returns_acc: torch.Tensor    # (N,) per-env discounted-return carry


@dataclasses.dataclass
class UpdateDraws:
    """Every draw of one update; ``None`` fields are drawn from the state's
    generator. Shapes as the consuming functions take them."""

    action_noise: Optional[torch.Tensor] = None         # (T, N, 2)
    env_draws: Optional[Sequence[StepDraws]] = None     # one per step
    disc: Optional[Sequence[wdgail_mod.DiscEpochDraws]] = None  # per epoch
    ppo_perms: Optional[torch.Tensor] = None            # (epochs, n_mb*mb)
    ppo_expert_idx: Optional[torch.Tensor] = None       # (epochs*n_mb, mb)
    val_pre: Optional[torch.Tensor] = None              # (chunks, 256)
    val_post: Optional[torch.Tensor] = None


def _dummy_expert(env_cfg: EnvConfig, device) -> ExpertBuffer:
    """A one-row expert buffer for ``algo="ppo"``, which never reads it."""
    w = env_cfg.bev_width

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    i32 = torch.int32
    obs = (z(1, STATE_OBS_DIM) if env_cfg.obs_mode == "state"
           else z(1, w, w, dtype=torch.uint8))
    return ExpertBuffer(
        render=RenderState(
            xy=z(1, 2), yaw=z(1), route_id=z(1, dtype=i32),
            head=z(1, dtype=i32), step=z(1, dtype=i32),
            stop_idx=z(1, dtype=i32) - 1, npc_pose=z(1, 0, 3),
            walker_pose=z(1, 0, 3),
        ),
        metrics=z(1, 4), obs=obs, actions=z(1, 2),
    )


class WDGAILLearner:
    """Builds the nets and optimizers and runs updates. With
    ``tcfg.algo == "ppo"`` the critic phases are skipped and GAE runs on
    the env reward (no expert buffer needed). ``policy_params`` and
    ``disc_params`` (flax layout) give the initial weights; by default they
    are drawn with numpy from ``tcfg.seed``. At ``obs_mode="state"`` only
    ``algo="ppo"`` trains: the reference's critic cannot take state obs
    (``models/discriminator.py::STATE_OBS_ERROR``), so ``"wdgail"``
    raises here. With a process ``group`` the reward scale's moments, both
    updates' gradients and the metrics are averaged over its ranks; with
    none every result is this process's alone."""

    def __init__(
        self,
        scene,
        env_cfg: EnvConfig,
        model_cfg: ModelConfig,
        tcfg: TrainConfig,
        expert: Optional[ExpertBuffer],
        expert_val: Optional[ExpertBuffer] = None,
        store_obs: bool = True,
        policy_params: Optional[Mapping] = None,
        disc_params: Optional[Mapping] = None,
        group=None,
    ):
        self.group = group
        self.scene = scene
        self.env_cfg = env_cfg
        self.model_cfg = model_cfg
        self.tcfg = tcfg
        self.device = scene.device
        if env_cfg.obs_mode == "state" and tcfg.algo != "ppo":
            raise NotImplementedError(STATE_OBS_ERROR)
        if expert is None:
            if tcfg.algo != "ppo":
                raise ValueError("WDGAIL needs an expert buffer")
            expert = _dummy_expert(env_cfg, self.device)
        self.expert = expert
        self.expert_val = expert_val if expert_val is not None else expert
        self.store_obs = store_obs

        w = env_cfg.bev_width
        self.obs_shape = (
            (STATE_OBS_DIM,) if env_cfg.obs_mode == "state"
            else (6 if env_cfg.obs_mode == "bev6" else 3, w, w))
        self._policy_params0 = (
            policy_params if policy_params is not None
            else init_flax_params(model_cfg, self.obs_shape, tcfg.seed))
        self._disc_params0 = (
            disc_params if disc_params is not None
            else init_critic_flax_params(model_cfg, self.obs_shape,
                                         tcfg.seed + 1))
        self.policy_optimizer = ppo_mod.make_policy_optimizer(tcfg)
        disc_mb = tcfg.gail_epoch * max(
            min(self.expert.size, tcfg.steps_per_env * tcfg.n_envs)
            // tcfg.gail_batch_size, 1
        )
        self.disc_optimizer = wdgail_mod.make_disc_optimizer(
            tcfg, mb_per_update=disc_mb)

    def init_state(self, route_ids=None,
                   reset_draws: Optional[ResetDraws] = None,
                   reset_gnss: Optional[torch.Tensor] = None
                   ) -> LearnerState:
        """Fresh nets from the initial weights, fresh optimizer states and
        reset envs (``tcfg.routes`` in turn unless ``route_ids``); the
        reset's draws come from the new generator unless given."""
        tcfg, dev = self.tcfg, self.device
        if route_ids is None:
            routes = tcfg.routes
            route_ids = [routes[i % len(routes)] for i in range(tcfg.n_envs)]
        route_ids = torch.as_tensor(route_ids, dtype=torch.int32,
                                    device=dev)
        generator = torch.Generator(device=dev)
        generator.manual_seed(tcfg.seed)
        env_states, metrics, render = reset_batch(
            self.scene, self.env_cfg, route_ids, generator,
            draws=reset_draws, gnss_noise=reset_gnss)
        policy = policy_from_flax(self._policy_params0, self.model_cfg,
                                  self.obs_shape, dev)
        disc = critic_from_flax(self._disc_params0, self.model_cfg,
                                self.obs_shape, dev)
        return LearnerState(
            policy=policy,
            policy_opt=self.policy_optimizer.init(list(policy.parameters())),
            disc=disc,
            disc_opt=self.disc_optimizer.init(list(disc.parameters())),
            env_states=env_states,
            metrics=metrics,
            render=render,
            gail_gamma=torch.tensor(tcfg.gail_gamma, dtype=torch.float32,
                                    device=dev),
            generator=generator,
            update_i=0,
            reward_rms=rms_mod.make_rms(device=dev),
            returns_acc=torch.zeros(route_ids.shape[0], device=dev),
        )

    def _gail_rewards(self, state: LearnerState, rollout, gail_raw):
        """The shifted (and, with ``gail_norm_reward``, scaled) GAIL reward,
        with the new reward statistics and return carry."""
        tcfg = self.tcfg
        reward_rms, returns_acc = state.reward_rms, state.returns_acc
        shifted = gail_raw + tcfg.gail_reward_shift
        if tcfg.gail_norm_reward:
            # VecNormalize-style: track the discounted return of the
            # SHIFTED reward per env and scale by its running std (scale
            # only, so softplus's positivity survives); the tracker is the
            # clamped EMA, which one warm-up outlier cannot poison
            rets = torch.empty_like(shifted)
            for t in range(shifted.shape[0]):
                rets[t] = returns_acc * tcfg.gamma + shifted[t]
                returns_acc = rets[t] * rollout.masks[t + 1]
            reward_rms = rms_mod.update_scale(reward_rms, rets.reshape(-1),
                                              self.group)
            shifted = torch.clamp(shifted / (reward_rms.std + 1e-8),
                                  -10.0, 10.0)
        return shifted, reward_rms, returns_acc

    def update(self, state: LearnerState,
               draws: Optional[UpdateDraws] = None
               ) -> Tuple[LearnerState, dict]:
        """One WDGAIL update (the warm-up epoch count from the update's
        1-based index); returns the new state and the update's metrics."""
        scene, env_cfg, tcfg = self.scene, self.env_cfg, self.tcfg
        d = draws if draws is not None else UpdateDraws()
        gen = state.generator
        n_epochs = wdgail_mod.warmup_epochs(tcfg, state.update_i + 1)

        with span("learner.rollout"):
            env_states, metrics, render, rollout, ep_stats = collect_rollout(
                scene, env_cfg, state.policy, state.env_states, state.metrics,
                state.render, gen, tcfg.steps_per_env, self.store_obs,
                action_noise=d.action_noise, env_draws=d.env_draws,
            )

        disc_opt = state.disc_opt
        reward_rms, returns_acc = state.reward_rms, state.returns_acc
        disc_aux = {}
        if tcfg.algo == "ppo":
            # no critic: GAE on the env reward (gail_coef 0, env_coef 1)
            z = torch.zeros((), device=self.device)
            pre = post = (z, z, z)
            with span("learner.returns"):
                returns = compute_returns(
                    rollout.gail_rewards, rollout.env_rewards,
                    rollout.values, rollout.masks, tcfg.gamma,
                    tcfg.gae_lambda, gail_coef=0.0, env_coef=1.0,
                )
        else:
            with span("learner.validation"):
                pre = wdgail_mod.validation_wd(
                    scene, env_cfg, state.disc, rollout, self.expert_val,
                    gen, policy_idx=d.val_pre)
            with span("learner.critic"):
                disc_opt, disc_aux = wdgail_mod.disc_update(
                    scene, env_cfg, tcfg, state.disc, self.disc_optimizer,
                    disc_opt, rollout, self.expert, gen, n_epochs, d.disc,
                    group=self.group)
            with span("learner.validation"):
                post = wdgail_mod.validation_wd(
                    scene, env_cfg, state.disc, rollout, self.expert_val,
                    gen, policy_idx=d.val_post)
            with span("learner.relabel"):
                gail_raw = wdgail_mod.relabel_rewards(scene, env_cfg,
                                                      state.disc, rollout)
                rollout.gail_rewards, reward_rms, returns_acc = (
                    self._gail_rewards(state, rollout, gail_raw))
            with span("learner.returns"):
                returns = compute_returns(
                    rollout.gail_rewards, rollout.env_rewards,
                    rollout.values, rollout.masks, tcfg.gamma,
                    tcfg.gae_lambda,
                )

        # BCGAIL: skip the BC batches when their weight can never be
        # nonzero (the reference computes them at weight 0); bc_loss then
        # logs 0, its true value
        bc_active = tcfg.bcgail and tcfg.gail_gamma > 0.0
        with span("learner.ppo"):
            policy_opt, ppo_aux = ppo_mod.ppo_update(
                scene, env_cfg, tcfg, state.policy, self.policy_optimizer,
                state.policy_opt, rollout, returns, gen, state.gail_gamma,
                self.expert if bc_active else None,
                perms=d.ppo_perms, expert_idx=d.ppo_expert_idx,
                group=self.group,
            )

        new_state = dataclasses.replace(
            state,
            policy_opt=policy_opt,
            disc_opt=disc_opt,
            env_states=env_states,
            metrics=metrics,
            render=render,
            gail_gamma=state.gail_gamma * tcfg.decay,   # ppo.py:136-137
            update_i=state.update_i + 1,
            reward_rms=reward_rms,
            returns_acc=returns_acc,
        )
        logstd = torch.tensor(self.model_cfg.logstd, device=self.device)
        out = dict(ep_stats)
        out.update({f"disc/{k}": v for k, v in disc_aux.items()})
        out.update({f"ppo/{k}": v for k, v in ppo_aux.items()})
        out.update({
            "disc/pre_val_wd": pre[0],
            "disc/pre_val_expert": pre[1],
            "disc/pre_val_policy": pre[2],
            "disc/post_val_wd": post[0],
            "disc/post_val_expert": post[1],
            "disc/post_val_policy": post[2],
            "ppo/gail_gamma": state.gail_gamma,
            "ppo/steer_std": torch.exp(logstd[0]),
            "ppo/throttle_std": torch.exp(logstd[1]),
            "gail_reward_mean": torch.mean(rollout.gail_rewards),
            "disc/reward_rms_std": reward_rms.std,
        })
        if self.group is not None:
            # the metrics averaged over the ranks (float32, as pmean
            # divides an integer count too)
            out = dict(zip(out, all_mean(
                [torch.as_tensor(v, dtype=torch.float32, device=self.device)
                 for v in out.values()], self.group)))
        return new_state, out
