"""The nets seam (``bench_port/nets/``): ``wdgail_bev6`` reads through it
the bits it read when its nets were written into the harness (weights,
FLOP counts, reference nets and their outputs, pinned below), and a
module of its own (``nets_residual_tiny.py``) comes in without an edit
to the harness."""
import hashlib
import json
import math
import os
import re

import pytest
import torch

from bench_port import flops
from bench_port.harness import train_cell
from bench_port.harness import weights as W
from bench_port.harness.spec import BENCH_DIR
from bench_port.nets import cnn4, of
from bench_port.plain_reference.frozen import config as fconf
from bench_port.plain_reference.nets import make_nets
from bench_port.tests import nets_residual_tiny as tiny
from bench_port.tests.tinycells import tiny_cell

CPU = torch.device("cpu")
BEV6 = (6, 192, 192)
# sha256 of each leaf's path, shape and float32 bytes, in tree order
PARAMS = {
    (1, False): "23ce8661d37d6355ac327fb75cc71b62e37e72c80b61593cb3b09cae4b17c031",
    (1, True): "edf2292c83ef82197417f0aa4b92b0a3fde9e5c63f6c3b89ff4fabc0b7c39c24",
    (2, False): "bdc6dda6a1aaea95ac98a819e487b9708774d10e8a8d4bf61db74213f18d8ad2",
    (2, True): "bca9ff380428d3d4063a203fc88f1fcfb8e9dcd7b882b3f9e3cc29df77b5e047",
}
# sha256 of value, mean, logstd and D on the seeded rows, one CPU thread
OUTPUTS = {
    "float32": "cda0127cc37da2922beee7bdddbaed87d359ffb0284f53c1242630c2cfdbcd7e",
    "fp8": "c62e1b846a79cec8ecb78afb45adf8ac80e7b71dce6b51e930db5ac9167dc2e2",
}
ENCODER = [("obs_enc.convs.0.weight", (32, 6, 4, 4)),
           ("obs_enc.convs.0.bias", (32,)),
           ("obs_enc.convs.1.weight", (64, 32, 4, 4)),
           ("obs_enc.convs.1.bias", (64,)),
           ("obs_enc.convs.2.weight", (128, 64, 4, 4)),
           ("obs_enc.convs.2.bias", (128,)),
           ("obs_enc.convs.3.weight", (256, 128, 4, 4)),
           ("obs_enc.convs.3.bias", (256,)),
           ("met_enc.embed.weight", (10, 8))]
POLICY_SD = ENCODER + [
    ("body.0.weight", (512, 25613)), ("body.0.bias", (512,)),
    ("body.1.weight", (512, 512)), ("body.1.bias", (512,)),
    ("body.2.weight", (512, 512)), ("body.2.bias", (512,)),
    ("head.weight", (256, 512)), ("head.bias", (256,)),
    ("out.weight", (3, 256)), ("out.bias", (3,))]
CRITIC_SD = ENCODER + [
    ("hidden.weight", (100, 25615)), ("hidden.bias", (100,)),
    ("out.weight", (1, 100)), ("out.bias", (1,))]
TINY_MODEL, TINY_SHAPE = tiny.MODEL, tiny.OBS_SHAPE


def bev6_model():
    with open(os.path.join(BENCH_DIR, "configs", "wdgail_bev6.json")) as f:
        return json.load(f)["model"]


def leaves(params):
    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                yield from walk(v, path + (k,))
            else:
                yield path + (k,), v
    yield from walk(params["params"], ())


def params_digest(params):
    h = hashlib.sha256()
    for path, v in leaves(params):
        h.update(("/".join(path) + str(tuple(v.shape))).encode())
        h.update(v.float().contiguous().numpy().tobytes())
    return h.hexdigest()


def rows(shape, b=2):
    g = torch.Generator().manual_seed(1)
    return (torch.rand((b,) + shape, generator=g),
            torch.rand(b, 4, generator=g), torch.rand(b, 2, generator=g))


@pytest.fixture
def residual():
    with tiny.registered():
        yield


def test_default_module_is_cnn4():
    assert "nets" not in bev6_model()
    assert of(bev6_model()) is cnn4
    assert of({"nets": "cnn4"}) is cnn4


@pytest.mark.parametrize("seed,critic", sorted(PARAMS))
def test_weights_are_bit_for_bit(seed, critic):
    p = W.make_params(bev6_model(), BEV6, critic, seed, CPU)
    assert params_digest(p) == PARAMS[seed, critic]


def test_flop_counts_are_pinned():
    m = bev6_model()
    # bev6.train.4096: 12,288 expert rows, 1 critic epoch in the window
    assert flops.update_flops(m, BEV6, 4096, 16, 12288, 4096, 1, 4,
                              8192) == 474627682861056
    assert flops.chunk_flops(m, BEV6, 4096, 16) == 31571081953280


def test_cnn4_reference_nets_are_bit_for_bit():
    m = bev6_model()
    pp = W.make_params(m, BEV6, False, 1, CPU)
    cp = W.make_params(m, BEV6, True, 1, CPU)
    obs, met, act = rows(BEV6)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for precision, digest in OUTPUTS.items():
            pol, disc = make_nets(m, BEV6, pp, cp, CPU, precision)
            assert [(k, tuple(v.shape)) for k, v
                    in pol.state_dict().items()] == POLICY_SD
            assert [(k, tuple(v.shape)) for k, v
                    in disc.state_dict().items()] == CRITIC_SD
            h = hashlib.sha256()
            with torch.no_grad():
                for t in (*pol(obs, met), disc(obs, met, act)):
                    h.update(t.contiguous().numpy().tobytes())
            assert h.hexdigest() == digest, precision
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("family", ["cnn4", tiny.NAME])
def test_parameters_follow_param_shapes(family, residual):
    """Each net's parameters, in order, are the leaves ``param_shapes``
    lists, each holding its own values (a layout apart); ``.out`` is the
    last Linear."""
    m, shape = dict(TINY_MODEL, nets=family), TINY_SHAPE
    assert of(m) is {"cnn4": cnn4, tiny.NAME: tiny}[family]
    pp = W.make_params(m, shape, False, 3, CPU)
    cp = W.make_params(m, shape, True, 3, CPU)
    nets = make_nets(m, shape, pp, cp, CPU)
    for net, params, critic in zip(nets, (pp, cp), (False, True)):
        listed = of(m).param_shapes(m, shape, critic)
        tree = dict(leaves(params))
        assert list(tree) == [path for path, _, _ in listed]
        for p, (path, shp, _) in zip(net.parameters(), listed, strict=True):
            assert tuple(tree[path].shape) == shp
            assert p.numel() == math.prod(shp)
            assert torch.equal(p.detach().flatten().sort().values,
                               tree[path].flatten().sort().values), path
        assert net.out is list(net.modules())[-1]


def test_module_of_its_own_runs_in_both_precisions(residual):
    m, shape = TINY_MODEL, TINY_SHAPE
    assert of(m) is tiny
    pp = W.make_params(m, shape, False, 3, CPU)
    cp = W.make_params(m, shape, True, 3, CPU)
    assert pp["params"]["ObsEncoder_0"]["Conv_2"]["kernel"].shape == (
        3, 3, 16, 16)
    assert pp["params"]["ObsEncoder_0"]["Conv_2"]["kernel"].abs().sum() > 0
    obs, met, act = rows(shape)
    out = {}
    for precision in ("float32", "fp8"):
        pol, disc = make_nets(m, shape, pp, cp, CPU, precision)
        with torch.no_grad():
            out[precision] = (*pol(obs, met)[:2], disc(obs, met, act))
        assert all(torch.isfinite(t).all() for t in out[precision])
    assert not torch.equal(out["float32"][2], out["fp8"][2])
    # the same weights without the residual conv (cnn4 reads Conv_0 and
    # Conv_1 alone) give other outputs: the residual conv takes part
    pol, disc = make_nets(dict(m, nets="cnn4"), shape, pp, cp, CPU)
    with torch.no_grad():
        assert not torch.equal(pol(obs, met)[0], out["float32"][0])
        assert not torch.equal(disc(obs, met, act), out["float32"][2])


def test_configs_takes_keys_only_a_module_reads(residual):
    from gail_carla_tpu_torch import config as pconf

    cell = tiny_cell("bev6.train.4096")
    cell.config["model"] = dict(TINY_MODEL)
    _, model, _ = train_cell.configs(cell, fconf)
    assert model.conv_channels == (8, 16)
    assert model.logstd == (-1.4, -3.2)
    assert not hasattr(model, "residual_blocks")
    with pytest.raises(TypeError, match="residual_blocks"):
        train_cell.configs(cell, pconf)
    cell.config["model"].pop("residual_blocks")
    _, model, _ = train_cell.configs(cell, pconf)
    assert model.conv_channels == (8, 16)


@pytest.mark.parametrize("name", ["no_such_nets", "../cnn4", 4])
def test_unknown_nets_name_fails_with_its_name(name):
    with pytest.raises(ValueError, match=re.escape(repr(name))):
        of({"nets": name})
    with pytest.raises(ValueError, match=re.escape(repr(name))):
        W.make_params({"nets": name}, TINY_SHAPE, False, 1, CPU)
