"""More than one GPU: env data parallelism over ``torch.distributed``.
Port of ``gail_carla_tpu/parallel/mesh.py``.

The JAX package shards the env batch over a mesh axis with ``shard_map``
and replicates the weights; here each rank of a process group is one
device. Rank r owns the contiguous block of envs ``[r n/D, (r+1) n/D)``
(what ``NamedSharding(P("dp"))`` gives device r), collects its own
rollout, draws its minibatches from its own block of the expert buffer,
and the update averages the gradients, the advantage and reward moments
and the metrics over the ranks (``parallel/collectives.py``), so every
replica applies the same steps. An env step involves no other rank.

The group's backend is NCCL on cards and gloo on the CPU (gloo also runs
on CUDA tensors, staged through the host). Only ``all_reduce`` is used.
Multi-GPU training launches one process per card:

    python -m torch.distributed.run --nproc_per_node=N \\
        -m gail_carla_tpu_torch.train --preset reference --n-envs M

where N divides M.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from gail_carla_tpu_torch.algo import wdgail as wdgail_mod
from gail_carla_tpu_torch.algo.buffers import ExpertBuffer
from gail_carla_tpu_torch.algo.learner import (
    LearnerState, UpdateDraws, WDGAILLearner,
)
from gail_carla_tpu_torch.config import EnvConfig, ModelConfig, TrainConfig

# the LearnerState fields with one row per env: each rank keeps its block
# (JAX's sharded set, plus the per-env return carry, which the JAX
# package replicates: ROADMAP §C)
ENV_FIELDS = ("env_states", "metrics", "render", "returns_acc")
# a 64-bit odd constant that spreads the rank over the seed's bits
_FOLD = 0x9E3779B97F4A7C15


def dp_group() -> Tuple[object, int, int]:
    """In place of ``make_mesh``: (the default group, this process's rank
    in it, its size). Raises unless ``torch.distributed`` is initialised:
    nothing trains on one rank quietly."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "sharded training needs an initialised torch.distributed "
            "process group (init_process_group, or a launch through "
            "python -m torch.distributed.run)")
    return dist.group.WORLD, dist.get_rank(), dist.get_world_size()


def map_tensors(fn, obj):
    """``fn`` applied to every tensor of a tree of dataclasses (the env
    and render states, a buffer), in field order; ``None`` stays."""
    if obj is None:
        return None
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj):
        return type(obj)(**{f.name: map_tensors(fn, getattr(obj, f.name))
                            for f in dataclasses.fields(obj)})
    raise TypeError(f"not a tensor tree: {type(obj).__name__}")


def _trim(buf: ExpertBuffer, world: int) -> ExpertBuffer:
    """The first rows of ``buf``, a multiple of ``world`` (demo rows
    repeat cyclically, so only duplicates go)."""
    m = (buf.size // world) * world
    return map_tensors(lambda a: a[:m], buf)


def _block(buf: ExpertBuffer, rank: int, world: int) -> ExpertBuffer:
    """Rank ``rank``'s contiguous block of a buffer of a multiple of
    ``world`` rows (a copy, so the whole buffer can be freed)."""
    n = buf.size // world
    return map_tensors(lambda a: a[rank * n:(rank + 1) * n].clone(), buf)


class ShardedWDGAILLearner(WDGAILLearner):
    """``WDGAILLearner`` whose update is data-parallel over the ranks of
    the default process group.

    Each rank owns ``n_envs / D`` envs. The expert buffer shards along
    its rows when it has at least D of them and ``algo != "ppo"``
    (``self.shard_expert``): it is trimmed to a multiple of D, each rank
    keeps its contiguous block and draws critic and BC minibatches from
    it, and the critic's optimizer counts the local minibatches. The validation
    buffer shards with it when it has at least D rows, else it is the
    expert's block.

    Randomness: the state's generator is replicated and advances alike on
    every rank. Each update draws one work seed from it and runs on a
    rank-local generator seeded from (work seed, rank), as the JAX
    package folds the device's index into a work key, so the replicated
    state (and a checkpoint) does not depend on the rank. Injected
    ``UpdateDraws`` are this rank's."""

    def __init__(
        self,
        scene,
        env_cfg: EnvConfig,
        model_cfg: ModelConfig,
        tcfg: TrainConfig,
        expert: Optional[ExpertBuffer],
        expert_val: Optional[ExpertBuffer] = None,
        store_obs: bool = True,
        policy_params=None,
        disc_params=None,
    ):
        group, self.rank, self.world = dp_group()
        if tcfg.n_envs % self.world:
            raise ValueError(f"n_envs={tcfg.n_envs} must divide over "
                             f"{self.world} ranks")
        self.shard_expert = (expert is not None and expert.size >= self.world
                             and tcfg.algo != "ppo")
        if self.shard_expert:
            expert = _trim(expert, self.world)
            expert_val = (
                _trim(expert_val, self.world)
                if expert_val is not None and expert_val.size >= self.world
                else expert)
        super().__init__(scene, env_cfg, model_cfg, tcfg, expert,
                         expert_val, store_obs=store_obs,
                         policy_params=policy_params,
                         disc_params=disc_params, group=group)
        n_loc = tcfg.n_envs // self.world
        self.env_block = (self.rank * n_loc, (self.rank + 1) * n_loc)
        if self.shard_expert:
            self.expert = _block(self.expert, self.rank, self.world)
            self.expert_val = _block(self.expert_val, self.rank, self.world)
            # the critic's LR schedule counts optimizer steps per update:
            # each rank runs min(local rows, local samples) / batch
            # minibatches per epoch
            disc_mb = tcfg.gail_epoch * max(
                min(self.expert.size,
                    tcfg.steps_per_env * tcfg.n_envs // self.world)
                // tcfg.gail_batch_size, 1)
            self.disc_optimizer = wdgail_mod.make_disc_optimizer(
                tcfg, mb_per_update=disc_mb)

    def init_full_state(self, route_ids=None, reset_draws=None,
                        reset_gnss=None) -> LearnerState:
        """The unsharded state of all ``n_envs`` envs, as
        ``WDGAILLearner.init_state`` makes it (the same on every rank)."""
        return super().init_state(route_ids, reset_draws, reset_gnss)

    def init_state(self, route_ids=None, reset_draws=None,
                   reset_gnss=None) -> LearnerState:
        """The unsharded initial state's env leaves cut to this rank's
        block: the reset draws and route ids are those of the unsharded
        ``init_state``."""
        return self.local_state(
            self.init_full_state(route_ids, reset_draws, reset_gnss))

    def local_state(self, full: LearnerState) -> LearnerState:
        """This rank's block of an unsharded state (a restored checkpoint,
        say); the replicated leaves are shared with ``full``."""
        a, b = self.env_block
        return dataclasses.replace(full, **{
            f: map_tensors(lambda t: t[a:b].clone(), getattr(full, f))
            for f in ENV_FIELDS})

    def global_state(self, state: LearnerState) -> LearnerState:
        """The unsharded layout of a sharded state (collective: every rank
        calls it). The env leaves are gathered in rank order by one
        ``all_reduce`` of a zero-padded full-size byte buffer; the
        replicated leaves are this rank's own (equal on every rank; rank 0
        writes the checkpoints)."""
        a, b = self.env_block
        n = self.tcfg.n_envs
        leaves = []
        for f in ENV_FIELDS:
            map_tensors(leaves.append, getattr(state, f))
        row_bytes = [t[0].numel() * t.element_size() for t in leaves]
        full = torch.zeros(n * sum(row_bytes), dtype=torch.uint8,
                           device=self.device)
        off = 0
        for t, rb in zip(leaves, row_bytes):
            block = full[off:off + n * rb].view(n, rb)
            block[a:b] = t.contiguous().view(torch.uint8).reshape(b - a, rb)
            off += n * rb
        dist.all_reduce(full, group=self.group)
        gathered, off = [], 0
        for t, rb in zip(leaves, row_bytes):
            shape = (n,) + t.shape[1:]
            # a fresh, aligned copy of each leaf's bytes to view as its
            # dtype (a leaf with empty rows has no bytes at all)
            gathered.append(
                full[off:off + n * rb].view(n, rb).clone().view(t.dtype)
                .reshape(shape) if rb else t.new_empty(shape))
            off += n * rb
        it = iter(gathered)
        return dataclasses.replace(state, **{
            f: map_tensors(lambda _: next(it), getattr(state, f))
            for f in ENV_FIELDS})

    def update(self, state: LearnerState,
               draws: Optional[UpdateDraws] = None
               ) -> Tuple[LearnerState, dict]:
        """One data-parallel update of this rank's envs; returns the new
        state (the replicated generator advanced by one work seed) and the
        metrics averaged over the ranks."""
        work = int(torch.randint(0, 2 ** 63 - 1, (), device=self.device,
                                 generator=state.generator))
        local = torch.Generator(device=self.device)
        local.manual_seed((work + self.rank * _FOLD) % (1 << 64))
        new_state, metrics = super().update(
            dataclasses.replace(state, generator=local), draws)
        return dataclasses.replace(new_state,
                                   generator=state.generator), metrics
