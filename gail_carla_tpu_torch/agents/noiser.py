"""Expert action noise, batched over envs.

Port of ``gail_carla_tpu/agents/noiser.py`` (``carla_gym/utils/
expert_noiser.py``, the reference's only intentional fault injection: it
widens the expert distribution for GAIL). The schedule runs on sim time
(10 Hz), which is what the reference's wall-clock schedule measured when
the sim ran at real time.

Usage (carla_exp.py:33-34,52-53):
    throttle noiser: frequency=15/min, intensity=10, min_amount=2.0 s
    steer ("Spike"): frequency=25/min, intensity=4,  min_amount=0.5 s

Randomness is injected: ``make_noiser`` takes a ``NoiserInitDraws`` and
``noiser_step`` a ``NoiserDraws``, each drawn from a ``torch.Generator``
when not given.

Sim times are on a 0.1 s grid and noise durations on a 0.01 s grid, so
the schedule's comparisons meet exact ties, where an ulp decides a
transition. The port computes what the JAX source says in float32: ``t``
is the float32 product ``step * dt`` and ``t - t0`` a float32
difference. A new duration ``min_amount + h / 100.0`` is computed as XLA
always compiles a division by a constant, a multiply by the float32
reciprocal (fused with the add: ``sim/transforms.py::div_const_add``);
``make_noiser``, eager in JAX, divides exactly. Inside a jitted scan XLA
on the CPU may also contract ``step * dt - t0`` into one rounding, and
not at every use of the same expression; the closed-loop tests name the
steps where that decides a tie. The other division divides a tensor by a
tensor: torch evaluates ``float / tensor`` as a reciprocal times the
float, and on the card ``tensor / float`` as a multiply by the
reciprocal, each of which rounds twice.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from gail_carla_tpu_torch.sim.transforms import div_const_add


@dataclasses.dataclass
class NoiserState:
    active: torch.Tensor     # (N,) bool, noise_being_set
    removing: torch.Tensor   # (N,) bool
    start_t: torch.Tensor    # (N,) f32 sim seconds
    end_t: torch.Tensor      # (N,) f32
    mean: torch.Tensor       # (N,) f32 +-0.001
    intensity: torch.Tensor  # (N,) f32
    amount: torch.Tensor     # (N,) f32 current noise_time_amount (s)
    sec_count: torch.Tensor  # (N,) i32 steps since the last 1 s boundary


class NoiserInitDraws(NamedTuple):
    """The draws of ``make_noiser`` for N envs."""

    intensity: torch.Tensor  # (N,) int in [-2, 3), added to the intensity
    amount: torch.Tensor     # (N,) int in [50, 201), hundredths of a second


class NoiserDraws(NamedTuple):
    """The draws of one ``noiser_step`` for N envs (or of T steps, with a
    leading step axis: ``at(t)`` picks one)."""

    coin: torch.Tensor       # int in [0, 2): the sign of a new noise
    seed: torch.Tensor       # int in [0, 61): start when below frequency
    amount: torch.Tensor     # int in [50, 201): the next noise duration

    def at(self, t: int) -> "NoiserDraws":
        return NoiserDraws(self.coin[t], self.seed[t], self.amount[t])


def _randint(lo: int, hi: int, shape, device, generator):
    return torch.randint(lo, hi, shape, generator=generator, device=device,
                         dtype=torch.int32)


def draw_noiser_init(n: int, device, generator: Optional[torch.Generator]
                     ) -> NoiserInitDraws:
    return NoiserInitDraws(_randint(-2, 3, (n,), device, generator),
                           _randint(50, 201, (n,), device, generator))


def draw_noiser(shape, device, generator: Optional[torch.Generator]
                ) -> NoiserDraws:
    """The draws of ``noiser_step`` for ``shape`` = (N,) or (T, N)."""
    shape = tuple(shape)
    return NoiserDraws(_randint(0, 2, shape, device, generator),
                       _randint(0, 61, shape, device, generator),
                       _randint(50, 201, shape, device, generator))


def _seconds(min_amount: float, hundredths: torch.Tensor) -> torch.Tensor:
    """``min_amount + hundredths / 100`` in float32, the division exact
    (``make_noiser``)."""
    h = hundredths.to(torch.float32)
    return min_amount + h / torch.full_like(h, 100.0)


def make_noiser(n: int, intensity: float, min_amount: float, device,
                generator: Optional[torch.Generator] = None,
                draws: Optional[NoiserInitDraws] = None) -> NoiserState:
    if draws is None:
        draws = draw_noiser_init(n, device, generator)
    z = torch.zeros(n, device=device)
    zb = torch.zeros(n, dtype=torch.bool, device=device)
    return NoiserState(
        active=zb,
        removing=zb,
        start_t=z,
        end_t=torch.ones(n, device=device),
        mean=z,
        intensity=intensity + draws.intensity.to(torch.float32),
        amount=_seconds(min_amount, draws.amount),
        sec_count=torch.zeros(n, dtype=torch.int32, device=device),
    )


def _noise_value(ns: NoiserState, t: torch.Tensor) -> torch.Tensor:
    """get_noise / get_noise_removing (expert_noiser.py:37-61)."""
    sign = torch.sign(ns.mean)
    grow = ns.mean + sign * (t - ns.start_t) * 0.03 * ns.intensity
    grow = torch.clamp(grow, -0.55, 0.55)
    added = (ns.end_t - ns.start_t) * 0.02 * ns.intensity
    peak = torch.clamp(ns.mean + sign * added, -0.55, 0.55)
    shrink = peak - sign * (t - ns.end_t) * 0.03 * ns.intensity
    return torch.where(ns.removing, shrink, grow)


def noiser_step(ns: NoiserState, t: torch.Tensor, frequency: float,
                min_amount: float, dt: float = 0.1,
                draws: Optional[NoiserDraws] = None,
                generator: Optional[torch.Generator] = None):
    """Advance the schedule one tick at sim time ``t`` (N,); returns
    (state', apply (N,) bool, noise (N,))."""
    if draws is None:
        draws = draw_noiser(ns.sec_count.shape, ns.sec_count.device,
                            generator)
    sec_count = ns.sec_count + 1
    second_passed = sec_count >= round(1.0 / dt)
    sec_count = torch.where(second_passed, 0, sec_count).to(torch.int32)

    # active -> removing transition (expert_noiser.py:71-74)
    to_removing = ns.active & ((t - ns.start_t) >= ns.amount) & ~ns.removing
    active = ns.active & ~to_removing
    removing = ns.removing | to_removing
    end_t = torch.where(to_removing, t, ns.end_t)

    # removing -> idle (expert_noiser.py:79-88)
    rm_done = removing & ((t - end_t) > ns.amount)
    removing = removing & ~rm_done
    amount = torch.where(
        rm_done,
        div_const_add(draws.amount.to(torch.float32), 100.0, min_amount),
        ns.amount)

    # idle + second boundary -> maybe start (expert_noiser.py:90-102)
    start_now = (second_passed & ~active & ~removing
                 & (draws.seed.to(torch.float32) < frequency))
    mean = torch.where(start_now,
                       torch.where(draws.coin == 0, 0.001, -0.001), ns.mean)
    start_t = torch.where(start_now, t, ns.start_t)
    active = active | start_now

    new = NoiserState(
        active=active, removing=removing, start_t=start_t, end_t=end_t,
        mean=mean, intensity=ns.intensity, amount=amount,
        sec_count=sec_count,
    )
    return new, active | removing, _noise_value(new, t)


def apply_throttle_noise(action: torch.Tensor, apply: torch.Tensor,
                         noise: torch.Tensor) -> torch.Tensor:
    """expert_noiser.py:138-157, on (N, 2) actions."""
    throttle = torch.where(apply,
                           torch.clamp(action[:, 1] + noise, -1.0, 1.0),
                           action[:, 1])
    return torch.stack([action[:, 0], throttle], dim=1)


def apply_steer_noise(action: torch.Tensor, apply: torch.Tensor,
                      noise: torch.Tensor, speed_kmh: torch.Tensor
                      ) -> torch.Tensor:
    """'Spike' branch (expert_noiser.py:116-136): steer noise scaled down
    with speed."""
    scale = torch.full_like(speed_kmh, 25.0) / (2.3 * speed_kmh + 5.0)
    steer = torch.where(apply,
                        torch.clamp(action[:, 0] + noise * scale, -1.0, 1.0),
                        action[:, 0])
    return torch.stack([steer, action[:, 1]], dim=1)
