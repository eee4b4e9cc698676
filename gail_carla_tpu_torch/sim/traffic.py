"""Background traffic: port of the zero-NPC short-circuits of
``gail_carla_tpu/sim/traffic.py`` (``:68`` and ``:241``). Any NPC
vehicles, walkers or scenario actors raise until the traffic slice."""
from __future__ import annotations

from gail_carla_tpu_torch.config import EnvConfig
from gail_carla_tpu_torch.sim.state import TrafficState, make_empty_traffic


def _check_zero_npc(cfg: EnvConfig) -> None:
    if cfg.n_npc_vehicles or cfg.n_npc_walkers or cfg.n_scenario_actors:
        raise NotImplementedError(
            "NPC vehicles, walkers and scenario actors are not ported yet"
        )


def reset_traffic(cfg: EnvConfig, n_envs: int, device) -> TrafficState:
    _check_zero_npc(cfg)
    return make_empty_traffic(n_envs, device)


def step_traffic(cfg: EnvConfig, traffic: TrafficState) -> TrafficState:
    _check_zero_npc(cfg)
    return traffic
