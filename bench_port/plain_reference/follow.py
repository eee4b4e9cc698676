"""The reference of a training cell: the frozen update, in float32 (or in
the control's fp8), following one update of the program stage by stage
and step by step from the program's own state. Of that update the
program's rollout (render states, metrics, actions, the act's values and
log-probs, env rewards, done flags), its relabelled rewards, its GAE
returns and, for every optimizer step of each net, the weights the step
started from, the loss and the gradients it took, are the inputs of what
follows them; each stage is checked by itself:

- the act: the policy's values and means at the rollout's states;
- every optimizer step of the critic and of PPO: the loss and the
  gradient on the step's rows from the program's weights before the step,
  and the weights after it against the frozen optimizer applied to the
  program's gradient, its moments carried from every step the program
  took since the optimizer's start;
- the relabel: the program's critic after its epochs, on every row;
- GAE: on the program's relabelled rewards, values and done flags.

The rollout itself is checked apart (``check.follow_sim`` on a sample of
envs, the stored observations against the plain renderer)."""
from __future__ import annotations

import dataclasses

import torch

from bench_port.plain_reference import check, update
from bench_port.plain_reference.frozen.algo import buffers as f_buf
from bench_port.plain_reference.frozen.algo import ppo as f_ppo
from bench_port.plain_reference.frozen.algo import wdgail as f_wdgail
from bench_port.plain_reference.frozen.ops.gae import compute_returns
from bench_port.plain_reference.nets import make_nets

NETS = ("policy", "critic")


@dataclasses.dataclass
class Step:
    """One optimizer step as the program took it: the loss whose gradient
    it took, the weights before the step and the gradients (host)."""

    loss: float
    params: list
    grads: list


@dataclasses.dataclass
class UpdateRecord:
    """What the program's followed update produced: its rollout's leaves
    (T+1 or T, N, ...), the observations it stored (packed, or None), the
    relabelled rewards before any shift, the GAE returns; per net every
    step of the update (``Step``), the weights after it and the gradients
    of every step the optimizer took before it."""

    render: object
    metrics: torch.Tensor
    obs: object
    actions: torch.Tensor
    logp: torch.Tensor
    values: torch.Tensor
    env_rewards: torch.Tensor
    masks: torch.Tensor
    gail_raw: torch.Tensor
    returns: torch.Tensor
    steps: dict
    after: dict
    prior_grads: dict


def load(net, params) -> None:
    with torch.no_grad():
        for p, q in zip(net.parameters(), params, strict=True):
            p.copy_(q)


def dev_list(xs, device):
    return [x.to(device) for x in xs]


def leaf_gaps(prog, ref, keep) -> torch.Tensor:
    """Per compared leaf, |‖prog‖ - ‖ref‖| over the larger of the
    reference leaf's norm and the median leaf's."""
    pn = torch.stack([torch.linalg.vector_norm(x.float()) for x in prog])
    rn = torch.stack([torch.linalg.vector_norm(x.float()) for x in ref])
    return ((pn - rn).abs() / torch.maximum(rn, rn.median()).clamp_min(
        1e-30))[keep]


def dir_gap(prog, ref, keep) -> float:
    """‖prog - ref‖ / ‖ref‖ over the compared leaves together."""
    d = sum(float((p.float() - r.float()).pow(2).sum())
            for p, r, k in zip(prog, ref, keep) if k)
    n = sum(float(r.float().pow(2).sum()) for r, k in zip(ref, keep) if k)
    return (d / max(n, 1e-60)) ** 0.5


class StepGaps:
    """The worst gaps over the followed steps of one net."""

    def __init__(self):
        self.v = {"loss": 0.0, "loss_terms": 0.0, "grad_first": None,
                  "grad_norm": 0.0, "grad_worst": 0.0, "change": 0.0}
        self.dirs = []

    def add(self, key, x):
        self.v[key] = max(self.v[key], float(x))


def step_gaps(gaps, loss_o, grads_o, ref):
    """Adds one step's gaps from the reference's (loss, gradients, size):
    the loss relative to the loss and to the size of its terms; the
    gradient's median and worst compared leaf by their norms, the first
    step's median apart; the gradient's direction (printed by step)."""
    loss_r, grads_r, size = ref
    keep = check.moving_leaves(grads_r)
    gaps.add("loss", abs(loss_o - loss_r) / max(abs(loss_r), 1e-12))
    gaps.add("loss_terms", abs(loss_o - loss_r) / max(size, 1e-12))
    lg = leaf_gaps(grads_o, grads_r, keep)
    if gaps.v["grad_first"] is None:
        gaps.v["grad_first"] = float(lg.median())
    gaps.add("grad_norm", lg.median())
    gaps.add("grad_worst", lg.max())
    gaps.dirs.append(round(dir_gap(grads_o, grads_r, keep), 4))
    return keep


def follow_net(net, other, opt, steps, prior_grads, after, step_fn,
               half_fn=None):
    """Follows the program's ``steps`` of one net. ``net`` is the
    reference's; ``other`` the control's net (fp8) in the program's place,
    or None for the program's own readings; ``half_fn`` the step with half
    of its batch left out, in the reference put in the program's place.
    Returns {side: StepGaps} for "program" or for "control" and "half"."""
    dev = next(net.parameters()).device
    out = ({"program": StepGaps()} if other is None
           else {"control": StepGaps(), "half": StepGaps()})
    state = opt.init(list(net.parameters()))
    scratch = [torch.zeros_like(p) for p in net.parameters()]
    for g in prior_grads:
        state = opt.step(scratch, dev_list(g, dev), state)
    for k, st in enumerate(steps):
        p_k = dev_list(st.params, dev)
        load(net, p_k)
        ref = step_fn(net, k)
        if other is None:
            keep = step_gaps(out["program"], st.loss, dev_list(st.grads, dev),
                             ref)
            # the program's step against the frozen optimizer applied to
            # the program's own gradient, from the same weights and moments
            mine = [p.clone() for p in p_k]
            state = opt.step(mine, dev_list(st.grads, dev), state)
            nxt = (steps[k + 1].params if k + 1 < len(steps) else after)
            d_prog = [q.to(dev) - p for q, p in zip(nxt, p_k)]
            d_ref = [q - p for q, p in zip(mine, p_k)]
            out["program"].add("change",
                               leaf_gaps(d_prog, d_ref, keep).max())
        else:
            load(other, p_k)
            step_gaps(out["control"], *step_fn(other, k)[:2], ref)
            step_gaps(out["half"], *half_fn(net, k)[:2], ref)
    return out


def expert_buffer(fscene, fcfg, demo):
    """The expert rows' buffer, rendered by the plain renderer."""
    demo.render_cls = check.f_env.RenderState
    return f_buf.build_expert_buffer(fscene, fcfg, demo,
                                     max_size=demo.xy.shape[0])


@dataclasses.dataclass
class Stages:
    """One side's outputs of the update's stages that are not optimizer
    steps: the act's values (T+1, N) and means (T, N, 2), the relabelled
    rewards and the returns; on the reference's side also the size of the
    terms that the value and the critic's output sum, per row."""

    values: torch.Tensor
    means: torch.Tensor
    gail_raw: torch.Tensor
    returns: torch.Tensor
    value_scale: torch.Tensor = None
    critic_scale: torch.Tensor = None


def follow_update(fscene, fcfg, ftcfg, model, obs_shape, init_params,
                  expert_demo, rec: UpdateRecord, feed, obs, logstd,
                  control: bool = False):
    """``rec`` the program's record, ``feed`` the update's draws, ``obs``
    the packed (T+1, N, W, W) observations of its rollout,
    ``init_params`` the flax-layout weights the nets are built from (their
    values are replaced by the program's). Returns (numbers, readings):
    the gaps of the program, or with ``control`` of the control, from the
    reference; the control's run also reads the faults planted in the
    reference put in the program's place (half of each step's batch left
    out; the relabel's and GAE's outputs shifted by a tenth of their RMS,
    where they are produced)."""
    if ftcfg.gail_norm_reward or ftcfg.bcgail and ftcfg.gail_gamma > 0:
        raise NotImplementedError("reward scaling and the BC blend")
    dev = fscene.device
    pol, disc = make_nets(model, obs_shape, *init_params, dev)
    fp8 = (make_nets(model, obs_shape, *init_params, dev, "fp8")
           if control else (None, None))
    T, N = rec.actions.shape[:2]
    w = obs.shape[-1]
    std = torch.exp(logstd)
    start = {k: (rec.steps[k][0].params if rec.steps[k] else rec.after[k])
             for k in NETS}

    # the act, with the policy the rollout ran
    load(pol, dev_list(start["policy"], dev))
    v, mu, v_scale = check.policy_outputs(pol, fcfg, obs.reshape(-1, w, w),
                                             rec.metrics.reshape(-1, 4))
    ref = Stages(values=v.reshape(T + 1, N),
                 means=mu.reshape(T + 1, N, 2)[:T], gail_raw=None,
                 returns=None, value_scale=v_scale)
    if control:
        load(fp8[0], dev_list(start["policy"], dev))
        v, mu, _ = check.policy_outputs(fp8[0], fcfg, obs.reshape(-1, w, w),
                                        rec.metrics.reshape(-1, 4))
        other = Stages(values=v.reshape(T + 1, N),
                       means=mu.reshape(T + 1, N, 2)[:T], gail_raw=None,
                       returns=None)
    else:
        other = Stages(values=rec.values,
                       means=rec.actions - std * feed.action_noise,
                       gail_raw=rec.gail_raw, returns=rec.returns)
    rollout = f_buf.Rollout(
        render=check.frozen(rec.render), metrics=rec.metrics, obs=obs,
        actions=rec.actions, logp=rec.logp, values=rec.values,
        env_rewards=rec.env_rewards, masks=rec.masks,
        gail_rewards=torch.zeros_like(rec.env_rewards))

    # the critic's steps
    expert = expert_buffer(fscene, fcfg, expert_demo)
    e_size = expert_demo.xy.shape[0]
    disc_opt = f_wdgail.make_disc_optimizer(
        ftcfg, ftcfg.gail_epoch * max(min(e_size, T * N)
                                      // ftcfg.gail_batch_size, 1))
    d_rows = [(d.expert_idx[i], d.policy_idx[i], d.alpha[i])
              for d in feed.disc for i in range(d.expert_idx.shape[0])]

    def d_step(net, k, half=False):
        e, p, a = d_rows[k]
        return update.disc_step(fscene, fcfg, ftcfg, net, rollout, expert,
                                e, p, a, half=half)

    sides = {"critic": follow_net(
        disc, fp8[1], disc_opt, rec.steps["critic"][:len(d_rows)],
        rec.prior_grads["critic"], rec.after["critic"], d_step,
        lambda net, k: d_step(net, k, True))}

    # the relabel with the program's critic after its epochs
    load(disc, dev_list(rec.after["critic"], dev))
    with check.HeadTerms(disc.out) as terms:
        ref.gail_raw = f_wdgail.relabel_rewards(fscene, fcfg, disc, rollout)
    ref.critic_scale = terms.scale()[:ref.gail_raw.numel()]
    ref.returns = compute_returns(rec.gail_raw + ftcfg.gail_reward_shift,
                                  rec.env_rewards, rec.values, rec.masks,
                                  ftcfg.gamma, ftcfg.gae_lambda)
    readings = {}
    if control:
        altered = dataclasses.replace(
            other, gail_raw=ref.gail_raw + 0.1 * ref.gail_raw.pow(2).mean(
            ).sqrt(), returns=ref.returns + 0.1 * ref.returns.pow(2).mean(
            ).sqrt())
        alt = stage_numbers(altered, ref, std)
        readings.update({f"fault.altered {k}": alt[k]
                         for k in ("relabel_gap", "returns_gap")})
        load(fp8[1], dev_list(rec.after["critic"], dev))
        other.gail_raw = f_wdgail.relabel_rewards(fscene, fcfg, fp8[1],
                                                  rollout)
        # GAE has no precision of its own: the control's is the reference's
        other.returns = ref.returns

    # PPO's steps
    batch = update.ppo_batch(rollout, rec.returns)
    mb = ftcfg.mini_batch_size
    idx_all = feed.ppo_perms.reshape(-1, mb)
    pol_opt = f_ppo.make_policy_optimizer(ftcfg)

    def p_step(net, k, half=False):
        return update.ppo_step(fscene, fcfg, ftcfg, net, rollout, batch,
                               idx_all[k], half=half)

    sides["policy"] = follow_net(
        pol, fp8[0], pol_opt, rec.steps["policy"][:idx_all.shape[0]],
        rec.prior_grads["policy"], rec.after["policy"], p_step,
        lambda net, k: p_step(net, k, True))

    numbers = stage_numbers(other, ref, std)
    for side in sides["policy"]:
        got, read = step_numbers(sides, side)
        if side in ("program", "control"):
            numbers.update(got)
        else:
            read.update(got)
        readings.update({f"{side} {k}": v for k, v in read.items()})
    if not control:
        numbers["steps_missing"] = sum(
            abs(len(rec.steps[k]) - n) for k, n in
            (("policy", idx_all.shape[0]), ("critic", len(d_rows))))
    return numbers, readings


def step_numbers(sides, side):
    """(numbers, readings) of one side's steps. Compared: each step's
    loss, the first step's gradient by the median compared leaf, each
    step's change. Printed: the gradients of every step by the median and
    the worst leaf, and by direction, step by step."""
    p, c = sides["policy"][side], sides["critic"][side]
    first = [x for x in (p.v["grad_first"], c.v["grad_first"])
             if x is not None]
    out = {"ppo_loss_gap": p.v["loss"], "critic_loss_gap": c.v["loss"],
           "grad_gap": max(first, default=float("inf"))}
    if side == "program":
        out["change_gap"] = max(p.v["change"], c.v["change"])
    read = {"ppo_loss_terms": p.v["loss_terms"],
            "critic_loss_terms": c.v["loss_terms"],
            "grad_median_all": max(p.v["grad_norm"], c.v["grad_norm"]),
            "grad_worst_all": max(p.v["grad_worst"], c.v["grad_worst"]),
            "ppo_grad_dir": p.dirs, "critic_grad_dir": c.dirs}
    return out, read


def stage_numbers(other: Stages, ref: Stages, std) -> dict:
    return {
        "value_gap": check.rel_to(other.values.reshape(-1),
                                  ref.values.reshape(-1), ref.value_scale),
        "action_gap": float(((other.means - ref.means).abs() / std).max()),
        "relabel_gap": check.rel_to(
            check.inverse_softplus(other.gail_raw).reshape(-1),
            check.inverse_softplus(ref.gail_raw).reshape(-1),
            ref.critic_scale),
        "returns_gap": check.rel_rms(other.returns, ref.returns),
    }
