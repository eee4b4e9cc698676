"""The conv encoder's memory layout (``models/processors.py::ObsEncoder``):
every convolution takes channels-last (NHWC) input and kernel, in the
forward and in the backward, while the obs, the parameters and every
public shape stay as they were. The features, the policy's outputs and the
critic's gradient penalty equal the same maths written out here with plain
NCHW ``F.conv2d`` calls.

Toy widths (4 convs 8-16-16-32 on 64 px, hidden 32), on the 3-channel
``bev`` and the 6-channel ``bev6`` obs.
"""
import copy
import dataclasses

import pytest
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from gail_carla_tpu_torch.config import ModelConfig
from gail_carla_tpu_torch.models import discriminator as disc_mod
from gail_carla_tpu_torch.models import policy as policy_mod

MODEL = ModelConfig(conv_channels=(8, 16, 16, 32), hidden_size=32,
                    head_size=16, disc_hidden=16, dtype="float32")
SHAPES = {"bev": (3, 64, 64), "bev6": (6, 64, 64)}
BATCH = 3
CL = torch.channels_last


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Conv2dCalls(TorchFunctionMode):
    """The (input, weight) of every ``F.conv2d`` call."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is F.conv2d:
            self.calls.append((args[0], args[1]))
        return func(*args, **(kwargs or {}))


class ConvOps(TorchDispatchMode):
    """The 4-D tensor arguments of every convolution the autograd engine
    runs, forward (``aten.convolution``) and backward."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.convolution.default,
                    torch.ops.aten.convolution_backward.default):
            self.calls.append((func, [a for a in args
                                      if torch.is_tensor(a) and a.dim() == 4]))
        return func(*args, **(kwargs or {}))


def _inputs(shape, seed):
    g = torch.Generator().manual_seed(seed)
    obs = torch.rand((BATCH,) + shape, generator=g)
    metrics = torch.stack([
        torch.randn(BATCH, generator=g) * 2e-4,
        torch.randn(BATCH, generator=g) * 2e-4,
        torch.rand(BATCH, generator=g) * 8.0,
        torch.randint(1, 7, (BATCH,), generator=g).float(),
    ], dim=1)
    action = torch.rand(BATCH, 2, generator=g)
    return obs, metrics, action


def _nets(shape, dtype="float32"):
    cfg = dataclasses.replace(MODEL, dtype=dtype)
    torch.manual_seed(0)
    return (policy_mod.PolicyNet(cfg, shape),
            disc_mod.DiscriminatorNet(cfg, shape))


def nchw_features(enc, obs):
    """The encoder in float32 on NCHW tensors: contiguous input and kernel
    for every conv, then the NHWC flatten flax uses."""
    x = ((obs - enc.mean) / enc.std).contiguous()
    for conv in enc.convs:
        x = F.conv2d(x, conv.weight.contiguous(), conv.bias, stride=2)
        x = F.leaky_relu(x, enc.cfg.leaky_slope).contiguous()
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def with_nchw_encoder(net):
    """A copy of ``net`` whose encoder is ``nchw_features``."""
    ref = copy.deepcopy(net)
    ref.obs_enc.forward = lambda obs: nchw_features(ref.obs_enc, obs)
    return ref


def assert_rel(got, want, what):
    """Largest gap within 1e-6 of the largest magnitude."""
    assert got.shape == want.shape, what
    gap = float((got - want).abs().max())
    size = float(want.abs().max())
    assert gap <= 1e-6 * size, f"{what}: gap {gap} of size {size}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", sorted(SHAPES))
def test_convs_take_channels_last(mode, dtype):
    """Every ``F.conv2d`` of the policy's forward and of the critic's
    penalty gets a channels-last input and kernel; the obs and the fp32
    parameters keep their NCHW layout."""
    shape = SHAPES[mode]
    pnet, dnet = _nets(shape, dtype)
    e, p = _inputs(shape, 1), _inputs(shape, 2)
    with Conv2dCalls() as rec:
        with torch.no_grad():
            policy_mod.act(pnet, e[0], e[1], generator=torch.Generator())
        disc_mod.grad_penalty(dnet, e, p, 10.0,
                              alpha=torch.rand(BATCH, 1, 1, 1))
    n_convs = len(MODEL.conv_channels)
    assert len(rec.calls) == 2 * n_convs
    for x, w in rec.calls:
        assert x.is_contiguous(memory_format=CL)
        assert w.is_contiguous(memory_format=CL)
        assert x.dtype == w.dtype == getattr(torch, dtype)
    for net in (pnet, dnet):
        for conv in net.obs_enc.convs:
            assert conv.weight.is_contiguous()
            assert conv.weight.dtype == torch.float32
    assert e[0].is_contiguous() and p[0].is_contiguous()


@pytest.mark.parametrize("mode", sorted(SHAPES))
def test_policy_backward_convs_stay_channels_last(mode):
    """PPO's path: the convolutions autograd runs for the forward and the
    backward of a policy loss all take channels-last tensors, so no
    layout change sits between them."""
    shape = SHAPES[mode]
    pnet, _ = _nets(shape)
    obs, metrics, action = _inputs(shape, 3)
    with ConvOps() as rec:
        value, logp, _ = policy_mod.evaluate_actions(pnet, obs, metrics,
                                                     action)
        torch.autograd.grad((value + logp).sum(), list(pnet.parameters()))
    funcs = [f for f, _ in rec.calls]
    n_convs = len(MODEL.conv_channels)
    assert funcs.count(torch.ops.aten.convolution.default) == n_convs
    assert funcs.count(torch.ops.aten.convolution_backward.default) == n_convs
    for _, tensors in rec.calls:
        assert tensors
        assert all(t.is_contiguous(memory_format=CL) for t in tensors)


@pytest.mark.parametrize("mode", sorted(SHAPES))
def test_encoder_and_policy_equal_nchw_convs(mode):
    """The features and the policy's value and mean equal the NCHW
    computation within 1e-6 relative; the features keep the flax order."""
    shape = SHAPES[mode]
    pnet, _ = _nets(shape)
    ref = with_nchw_encoder(pnet)
    obs, metrics, _ = _inputs(shape, 4)
    with torch.no_grad():
        feats = pnet.obs_enc(obs)
        want = nchw_features(pnet.obs_enc, obs)
        value, mean, logstd = pnet(obs, metrics)
        rvalue, rmean, rlogstd = ref(obs, metrics)
    assert feats.shape == (BATCH, pnet.obs_enc.out_dim)
    assert feats.dtype == torch.float32 and feats.is_contiguous()
    assert_rel(feats, want, "features")
    assert_rel(value, rvalue, "value")
    assert_rel(mean, rmean, "mean")
    assert torch.equal(logstd, rlogstd)


@pytest.mark.parametrize("mode", sorted(SHAPES))
def test_grad_penalty_equals_nchw_convs(mode):
    """The penalty's loss and its weight gradients (through the double
    backward) equal the NCHW computation within 1e-6 relative; the obs
    gradient the penalty takes keeps the obs' shape (B, C, H, W)."""
    shape = SHAPES[mode]
    _, dnet = _nets(shape)
    ref = with_nchw_encoder(dnet)
    e, p = _inputs(shape, 5), _inputs(shape, 6)
    alpha = torch.rand(BATCH, 1, 1, 1, generator=torch.Generator()
                       .manual_seed(7))
    losses, grads = [], []
    for net in (dnet, ref):
        gp = disc_mod.grad_penalty(net, e, p, 10.0, alpha=alpha)
        losses.append(gp)
        grads.append(torch.autograd.grad(gp, list(net.parameters()),
                                         allow_unused=True))
    assert float(losses[0].detach()) > 0.1
    assert_rel(losses[0].detach(), losses[1].detach(), "penalty")
    names = [n for n, _ in dnet.named_parameters()]
    for n, g, rg in zip(names, *grads):
        assert (g is None) == (rg is None), n
        if g is not None:
            assert_rel(g, rg, f"grad {n}")

    mix = (alpha * e[0] + (1 - alpha) * p[0]).requires_grad_(True)
    obs_grads = []
    for net in (dnet, ref):
        d = net(mix, e[1], e[2])
        (g,) = torch.autograd.grad(d.sum(), mix)
        obs_grads.append(g)
    assert obs_grads[0].shape == (BATCH,) + shape
    assert_rel(obs_grads[0], obs_grads[1], "obs gradient")
