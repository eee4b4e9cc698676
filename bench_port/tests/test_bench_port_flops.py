"""``bench_port/flops.py`` against PyTorch's own count of the operations
of each configuration's reference nets, by its nets module
(``bench_port/nets/``: ``cnn4`` at the preset's widths, the tests'
residual module at a tiny size), and the render's bytes by hand."""
import json
import os

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from bench_port import flops
from bench_port.harness import weights as W
from bench_port.harness.spec import BENCH_DIR
from bench_port.plain_reference.frozen.models.discriminator import (
    grad_penalty,
)
from bench_port.plain_reference.nets import make_nets
from bench_port.tests import nets_residual_tiny as tiny


class Count(TorchDispatchMode):
    """FLOPs of every aten op that PyTorch's counter knows, as run."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        f = flop_registry.get(func._overloadpacket)
        if f is not None:
            self.n += f(*args, **kwargs, out_val=out)
        return out


def configured():
    """(config, model, obs shape) of every configuration file, each on its
    own obs, and ``wdgail_bev6`` also on the 3-channel obs of the
    reference preset: a new configuration's nets module is counted here
    without an edit."""
    out = []
    for name in sorted(os.listdir(os.path.join(BENCH_DIR, "configs"))):
        with open(os.path.join(BENCH_DIR, "configs", name)) as f:
            cfg = json.load(f)
        w = cfg["bev_width"]
        out.append((cfg["name"], cfg["model"],
                    (6 if cfg["obs_mode"] == "bev6" else 3, w, w)))
        if cfg["name"] == "wdgail_bev6":
            out.append((cfg["name"], cfg["model"], (3, w, w)))
    return out + [("tests", tiny.MODEL, tiny.OBS_SHAPE)]


@pytest.fixture(scope="module", params=configured(),
                ids=lambda p: f"{p[0]}-{p[1].get('nets', 'cnn4')}-{p[2][0]}")
def nets(request):
    """The nets of each configuration (and of the tests' residual module),
    by dispatch on the model's nets module."""
    _, m, shape = request.param
    cpu = torch.device("cpu")
    with tiny.registered():
        pol, disc = make_nets(m, shape, W.make_params(m, shape, False, 1, cpu),
                              W.make_params(m, shape, True, 1, cpu), cpu)
        yield m, shape, pol, disc


def inputs(shape, b=2):
    g = torch.Generator().manual_seed(0)
    return (torch.rand((b,) + shape, generator=g), torch.rand(b, 4,
                                                              generator=g),
            torch.rand(b, 2, generator=g))


def test_forward_and_training_rows(nets):
    m, shape, pol, disc = nets
    obs, met, act = inputs(shape)
    with Count() as c:
        pol(obs, met)
    assert c.n / 2 == flops.forward(m, shape, False)
    with Count() as c:
        disc(obs, met, act)
    assert c.n / 2 == flops.forward(m, shape, True)
    with Count() as c:
        v, mu, _ = pol(obs, met)
        (v.sum() + mu.sum()).backward()
    assert c.n / 2 == flops.train_row(m, shape, False)
    with Count() as c:
        disc(obs, met, act).sum().backward()
    assert c.n / 2 == flops.train_row(m, shape, True)


def test_penalty_counts_what_it_needs(nets):
    """The penalty needs its forward, the gradient to the image and that
    gradient's backward: 4 forwards. Autograd runs more (it also carries
    zeros back through the forward graph), so the count is at most what
    runs."""
    m, shape, _, disc = nets
    obs, met, act = inputs(shape)
    with Count() as c:
        disc(obs, met, act)
    fwd = c.n / 2
    with Count() as c:
        gp = grad_penalty(disc, (obs, met, act), (obs.flip(0), met, act),
                          alpha=torch.full((2, 1, 1, 1), 0.3))
        torch.autograd.grad(gp, list(disc.parameters()), allow_unused=True)
    assert flops.penalty_row(m, shape) == 4 * fwd
    assert flops.penalty_row(m, shape) <= c.n / 2


def test_update_total_at_the_preset():
    with open(os.path.join(BENCH_DIR, "configs", "wdgail_bev6.json")) as f:
        m = json.load(f)["model"]
    shape = (6, 192, 192)
    fp, fc = flops.forward(m, shape, False), flops.forward(m, shape, True)
    total = flops.update_flops(m, shape, 4096, 16, 12288, 4096, 1, 4, 8192)
    act = 17 * 4096 * fp
    val = 4 * 12288 * fc
    disc = 3 * 4096 * (2 * flops.train_row(m, shape, True) + 4 * fc)
    ppo = 4 * 8 * 8192 * flops.train_row(m, shape, False)
    assert total == act + val + disc + 65536 * fc + ppo
    assert 4.6e14 < total < 4.9e14


def test_render_bytes():
    assert flops.render_bytes(2, 6, 4) == 2 * 6 * 16 * 4 + 2 * 24
    assert flops.render_bytes(1, 3, 4, 1, 2, 5) == (
        3 * 16 * 4 + 24 + 3 * 20 + 20)
    assert flops.roofline_share(1.0, 2.0) == 50.0
    assert flops.roofline_share(1.0, 0.0) is None
