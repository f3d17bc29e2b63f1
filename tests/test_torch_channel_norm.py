"""The conv stack's fused channel LayerNorm
(lightzero_tpu_torch/models/channel_norm.py).

On the CPU: the dispatch rule (CPU tensors take the plain version; a map
on the card whose channels are not a multiple of 4 or above
``MAX_CHANNELS``, or of another type or residual shape, is refused); the plain backward formula
``channel_norm_backward_reference`` against autograd of the plain forward
in float64; the conv stack's outputs and gradients bitwise those of the ops
it ran before (``_before_*``, copies kept here) at every site that now goes
through ``channel_norm``; the bytes counter only while a profile records.

On the card (marked ``benchmark``, skipped without CUDA): the kernel pair
``csrc/channel_norm.cu`` against the plain version: the output, each row's
mean and rstd bitwise aten's, and the backward (dx, dgamma, dbeta, the
residual's gradient) against the plain formula in float64, at C in {16, 32,
64, 96} and at the widest C the kernel takes, with and without the residual,
at row counts that do not fill the last block and at the benchmark cells'
shapes; two runs bitwise equal; one launch a site, counted, and the counted
launches equal to the profiler's. tests/conftest.py imports JAX, which the card's machine
lacks, so run them there without it:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_channel_norm.py``.
This file imports no JAX."""
import json
from types import SimpleNamespace

import pytest
import torch
from torch import nn

import lightzero_tpu_torch.models.channel_norm as cn
from lightzero_tpu_torch.models.alphazero import AlphaZeroModel
from lightzero_tpu_torch.models.channel_norm import (
    MAX_CHANNELS,
    channel_norm,
    channel_norm_backward_reference,
    channel_norm_reference,
    kernel_takes,
)
from lightzero_tpu_torch.models.common import (
    LAYER_NORM_EPS,
    ConvNHWC,
    DownSample,
    RepresentationNetworkConv,
    ResBlock,
    avg_pool_nhwc,
    conv_reduce,
    conv_transition,
)
from lightzero_tpu_torch.utils import profiling

pytestmark = pytest.mark.unittest

CHANNELS = (16, 32, 64, 96)

# (label, map shape, residual): the shapes the benchmark's cells give the
# kernel. The search's root and leaf maps (2,048 roots, 6x6 latents of 64
# channels, 16-channel heads, the 96x96 observation's first 48x48x32 map);
# UniZero's and the MoE cell's encoder (704 and 5,632 frames of 64x64: the
# 32x32x32 and 16x16x64 maps); MuZero's learner (256 rows x 6 frames)
CELL_SHAPES = (
    ("search.transition", (2048, 6, 6, 64), True),
    ("search.head", (2048, 6, 6, 16), False),
    ("search.initial", (2048, 48, 48, 32), False),
    ("unizero_learn.encoder", (704, 32, 32, 32), False),
    ("moe_learn.encoder", (5632, 32, 32, 32), False),
    ("moe_learn.encoder_res", (5632, 16, 16, 64), True),
    ("muzero_learn.encoder", (1536, 48, 48, 32), True),
)


def _norm(C: int, seed: int, dtype=torch.float32, device="cpu") -> nn.LayerNorm:
    g = torch.Generator().manual_seed(seed)
    norm = nn.LayerNorm(C, eps=LAYER_NORM_EPS)
    with torch.no_grad():
        norm.weight.copy_(1.0 + 0.1 * torch.randn(C, generator=g))
        norm.bias.copy_(0.1 * torch.randn(C, generator=g))
    return norm.to(dtype=dtype, device=device)


def _inputs(shape, residual: bool, seed: int, dtype=torch.float32, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(shape, generator=g) * 2.0 + 0.5).to(dtype=dtype, device=device)
    res = torch.randn(shape, generator=g).to(dtype=dtype, device=device) if residual else None
    dy = torch.randn(shape, generator=g).to(dtype=dtype, device=device)
    return x, res, dy


# ------------------------------------------------------------------ CPU

@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("C", CHANNELS)
def test_cpu_tensors_take_the_plain_version(C, residual):
    x, res, _ = _inputs((3, 5, 4, C), residual, seed=C)
    norm = _norm(C, seed=1)
    before = cn.channel_norm.launches
    got = channel_norm(x, norm, residual=res)
    assert torch.equal(got, channel_norm_reference(x, norm, res))
    assert cn.channel_norm.launches == before


def _fake(shape, cuda=True, dtype=torch.float32):
    return SimpleNamespace(shape=torch.Size(shape), dim=lambda: len(shape), is_cuda=cuda,
                           dtype=dtype)


def _fake_norm(C, cuda=True, dtype=torch.float32):
    return SimpleNamespace(normalized_shape=(C,), weight=_fake((C,), cuda, dtype),
                           bias=_fake((C,), cuda, dtype))


@pytest.mark.parametrize("case,route", [
    ("cuda float32 C=64", "kernel"),
    ("cuda float32 C=16 with residual", "kernel"),
    ("cuda float32 C=256", "kernel"),
    ("cpu", "plain"),
    ("C=6", "error"),
    ("C=260", "error"),
    ("float64", "error"),
    ("residual of another shape", "error"),
    ("norm over two axes", "error"),
])
def test_the_dispatch_rule(case, route):
    x, norm, res = _fake((2, 3, 3, 64)), _fake_norm(64), None
    if case == "cuda float32 C=16 with residual":
        x, norm, res = _fake((2, 3, 3, 16)), _fake_norm(16), _fake((2, 3, 3, 16))
    elif case == "cuda float32 C=256":
        x, norm = _fake((2, 3, 3, MAX_CHANNELS)), _fake_norm(MAX_CHANNELS)
    elif case == "cpu":
        x = _fake((2, 3, 3, 64), cuda=False)
    elif case == "C=6":
        x, norm = _fake((2, 3, 3, 6)), _fake_norm(6)
    elif case == "C=260":
        x, norm = _fake((2, 3, 3, 260)), _fake_norm(260)
    elif case == "float64":
        x, norm = _fake((2, 3, 3, 64), dtype=torch.float64), _fake_norm(64, dtype=torch.float64)
    elif case == "residual of another shape":
        res = _fake((2, 3, 3, 1))
    elif case == "norm over two axes":
        norm = SimpleNamespace(normalized_shape=(3, 64), weight=norm.weight, bias=norm.bias)
    assert kernel_takes(x, norm, res) is (route == "kernel")
    if route == "error":
        # a map on the card that the kernel cannot take is refused, not
        # given to the plain version
        with pytest.raises(ValueError, match="channel_norm: the kernel takes"):
            channel_norm(x, norm, res)


def _stats(x: torch.Tensor, eps: float):
    mean = x.mean(-1)
    var = ((x - mean[..., None]) ** 2).mean(-1)
    return mean, torch.rsqrt(var + eps)


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("C", CHANNELS)
def test_plain_backward_formula_matches_autograd_in_float64(C, residual):
    f64 = torch.float64
    x, res, dy = _inputs((4, 3, 5, C), residual, seed=10 + C, dtype=f64)
    norm = _norm(C, seed=2, dtype=f64)
    leaves = [x.requires_grad_(), norm.weight, norm.bias] + ([res.requires_grad_()] if residual
                                                               else [])
    y = channel_norm_reference(x, norm, res)
    want = torch.autograd.grad(y, leaves, dy)
    mean, rstd = _stats(x.detach(), norm.eps)
    dx, dw, db, dres = channel_norm_backward_reference(dy, x.detach(), y.detach(), mean, rstd,
                                                       norm.weight.detach())
    got = [dx, dw, db] + ([dres] if residual else [])
    for name, g, w in zip(("dx", "dweight", "dbias", "dres"), got, want):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12, msg=name)


# the conv stack's ops as they stood before they went through channel_norm:
# the yardstick the CPU path is held to, bitwise

def _before_res_block(blk: ResBlock, x):
    y = torch.relu(blk.norm[0](blk.conv[0](x)))
    y = blk.norm[1](blk.conv[1](y))
    return torch.relu(x + y)


def _before_down_sample(ds: DownSample, x):
    n = ds.num_resblocks
    x = torch.relu(ds.norm[0](ds.conv[0](x)))
    for blk in ds.res[:n]:
        x = _before_res_block(blk, x)
    x = torch.relu(ds.norm[1](ds.conv[1](x)))
    for blk in ds.res[n:2 * n]:
        x = _before_res_block(blk, x)
    x = avg_pool_nhwc(x)
    for blk in ds.res[2 * n:]:
        x = _before_res_block(blk, x)
    return avg_pool_nhwc(x)


def _before_representation(net: RepresentationNetworkConv, obs):
    if hasattr(net, "downsample"):
        x = _before_down_sample(net.downsample, obs)
    else:
        x = torch.relu(net.norm[0](net.conv[0](obs)))
    for blk in net.res:
        x = _before_res_block(blk, x)
    return x


def _site(name: str, g: torch.Generator):
    """(the site as it runs now, as it ran before, its inputs, the module
    that holds its parameters) on the CPU."""
    if name == "res_block":
        blk = ResBlock(16, g)
        return (blk, lambda x: _before_res_block(blk, x), (torch.randn(2, 5, 5, 16, generator=g),),
                blk)
    if name == "down_sample":
        ds = DownSample(4, 16, num_resblocks=1, generator=g)
        return (ds, lambda x: _before_down_sample(ds, x),
                (torch.randn(2, 24, 24, 4, generator=g),), ds)
    if name in ("representation", "representation_no_downsample"):
        down = name == "representation"
        net = RepresentationNetworkConv(4, 16, num_res_blocks=1, downsample=down, generator=g)
        obs = torch.randn(2, 24 if down else 6, 24 if down else 6, 4, generator=g)
        return net, lambda o: _before_representation(net, o), (obs,), net
    if name == "transition":
        conv, norm = ConvNHWC(16 + 2, 16, generator=g), nn.LayerNorm(16, eps=LAYER_NORM_EPS)
        blocks = nn.ModuleList([ResBlock(16, g)])

        def before(latent, planes):
            x = torch.relu(norm(conv(torch.cat([latent, planes], dim=-1))) + latent)
            for blk in blocks:
                x = _before_res_block(blk, x)
            return x

        return ((lambda latent, planes: conv_transition(conv, norm, blocks, latent, planes)),
                before,
                (torch.randn(2, 6, 6, 16, generator=g), torch.randn(2, 6, 6, 2, generator=g)),
                nn.ModuleList([conv, norm, blocks]))
    if name == "reduce":
        conv, norm = ConvNHWC(16, 8, 1, generator=g), nn.LayerNorm(8, eps=LAYER_NORM_EPS)

        def before(x):
            r = torch.relu(norm(conv(x)))
            return r.reshape(r.shape[0], -1)

        return ((lambda x: conv_reduce(conv, norm, x)), before,
                (torch.randn(2, 6, 6, 16, generator=g),), nn.ModuleList([conv, norm]))
    if name == "alphazero_stem":
        model = AlphaZeroModel((6, 6, 3), 36, num_channels=16, num_res_blocks=1, generator=g)

        def before(obs):
            x = torch.relu(model.norm[0](model.conv[0](obs)))
            for blk in model.res:
                x = _before_res_block(blk, x)
            flat = x.reshape(x.shape[0], -1)
            return model.mlp[0](flat), torch.tanh(model.mlp[1](flat)[..., 0])

        return model, before, (torch.randn(2, 6, 6, 3, generator=g),), model
    raise KeyError(name)


@pytest.mark.parametrize("name", ["res_block", "down_sample", "representation",
                                  "representation_no_downsample", "transition", "reduce",
                                  "alphazero_stem"])
def test_conv_stack_outputs_and_gradients_bitwise_unchanged_on_the_cpu(name):
    now, before, inputs, holder = _site(name, torch.Generator().manual_seed(7))
    params = list(holder.parameters())
    got_in = [t.clone().requires_grad_() for t in inputs]
    exp_in = [t.clone().requires_grad_() for t in inputs]
    got, exp = now(*got_in), before(*exp_in)
    got = got if isinstance(got, tuple) else (got,)
    exp = exp if isinstance(exp, tuple) else (exp,)
    for a, b in zip(got, exp):
        assert torch.equal(a, b)
    grads_got = torch.autograd.grad(sum(a.square().sum() for a in got), got_in + params)
    grads_exp = torch.autograd.grad(sum(b.square().sum() for b in exp), exp_in + params)
    for a, b in zip(grads_got, grads_exp):
        assert torch.equal(a, b)


def _counting_channel_norm(x, norm, residual=None):
    """The plain version, counted as the kernel pair counts its launches:
    one a forward, two more when the backward reaches the output."""
    y = channel_norm_reference(x, norm, residual)
    cn.channel_norm.launches += 1
    if y.requires_grad:
        def backward(_):
            cn.channel_norm.launches += 2
        y.register_hook(backward)
    return y


@pytest.mark.parametrize("path", ["inference", "learn"])
def test_launches_equal_sites_times_network_calls(path, monkeypatch):
    # the count chip_smoke.py holds Connect4 MuZero's eval and learn step to
    import chip_smoke
    from lightzero_tpu_torch.configs.connect4_muzero_ft import main_config
    from lightzero_tpu_torch.models import common
    from lightzero_tpu_torch.parallel.dryrun import random_batch
    from lightzero_tpu_torch.policy import MuZeroPolicy

    monkeypatch.setattr(common, "channel_norm", _counting_channel_norm)
    launches = cn.channel_norm.launches
    policy = MuZeroPolicy(main_config.policy, device="cpu", seed=0)
    model = policy.model
    # the stem and a res block; a res block and two heads; the transition,
    # a res block and the reward head
    assert [chip_smoke.conv_norm_sites(net) for net in (
        model.representation_network, model.prediction_network, model.dynamics_network)] == [3, 4, 4]
    obs = torch.randn(4, 6, 7, 3, generator=torch.Generator().manual_seed(0))
    with chip_smoke.counted_norm_launches(device="cpu") as counts:
        if path == "inference":
            with torch.no_grad():
                out = model.initial_inference(obs)
                model.recurrent_inference(out.latent_state, torch.tensor([0, 1, 2, 6]))
        else:
            K, A = policy.num_unroll_steps, 7
            batch = random_batch(4, K, A, seed=0)
            batch = batch._replace(obs=torch.randn(4, K + 1, 6, 7, 3,
                                                   generator=torch.Generator().manual_seed(1)))
            policy.forward_learn(policy.init_train_state(), batch)
    if path == "inference":
        assert counts["expected"] == 3 + 4 + 4 + 4
    chip_smoke.check_norm_launches(counts, path)
    cn.channel_norm.launches = launches


def test_the_bytes_counter_records_only_while_a_profile_records(tmp_path):
    profiling.counters.clear()
    launches = cn.channel_norm.launches
    cn._launched(128)
    assert "channel_norm.bytes" not in profiling.counters
    with profiling.torch_trace(str(tmp_path / "profile")):
        cn._launched(256)
        cn._launched(64)
    assert profiling.counters["channel_norm.bytes"] == [256, 64]
    assert cn.channel_norm.launches == launches + 3
    with open(tmp_path / "profile" / "spans.json") as f:
        assert json.load(f)["counters"]["channel_norm.bytes"] == [256, 64]
    profiling.counters.clear()
    cn.channel_norm.launches = launches


# ----------------------------------------------------------------- card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


def _scaled_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over max |b|: a gap relative to the tensor's scale."""
    return float((a.double() - b.double()).abs().max() / b.double().abs().max().clamp_min(1e-30))


# float32 gaps relative to each tensor's largest entry: a few float32 steps
# (6e-8) in dx; the parameters' gradients are sums over every row, which the
# kernel takes in double
DX_TOL = 1e-5
PARAM_TOL = 1e-6


def _kernel_run(shape, residual: bool, seed: int, dev):
    """The kernel's output and gradients through autograd on float32
    inputs, with the inputs."""
    x, res, dy = _inputs(shape, residual, seed, device=dev)
    norm = _norm(shape[-1], seed + 1, device=dev)
    xi = x.clone().requires_grad_()
    ri = res.clone().requires_grad_() if residual else None
    y = channel_norm(xi, norm, ri)
    y.backward(dy)
    got = dict(y=y.detach(), dx=xi.grad, dw=norm.weight.grad, db=norm.bias.grad,
               dres=ri.grad if residual else None)
    return got, (x, res, dy, norm)


def _check_kernel(shape, residual: bool, seed: int):
    """The kernel against the plain version. The output, and each row's
    mean and rstd, bitwise aten's (``torch.native_layer_norm``). The
    backward against the plain formula in float64: dx, dgamma, dbeta within
    their tolerances, the residual's gradient bitwise the masked dy."""
    dev = _card()
    got, (x, res, dy, norm) = _kernel_run(shape, residual, seed, dev)
    f64 = torch.float64
    with torch.no_grad():
        assert torch.equal(got["y"], channel_norm_reference(x, norm, res))
        stats = cn._forward(x, norm.weight, norm.bias, res, norm.eps, save=True)[2]
        mean, rstd = (t.reshape(shape[:-1]) for t in stats)
        _, aten_mean, aten_rstd = torch.native_layer_norm(x, (shape[-1],), norm.weight, norm.bias,
                                                          norm.eps)
        assert torch.equal(mean, aten_mean.reshape(mean.shape))
        assert torch.equal(rstd, aten_rstd.reshape(rstd.shape))
        x64, w64 = x.to(f64), norm.weight.to(f64)
        dx, dw, db, g = channel_norm_backward_reference(dy.to(f64), x64, got["y"].to(f64),
                                                        mean.to(f64), rstd.to(f64), w64)
    assert _scaled_gap(got["dx"], dx) <= DX_TOL
    assert _scaled_gap(got["dw"], dw) <= PARAM_TOL
    assert _scaled_gap(got["db"], db) <= PARAM_TOL
    if residual:
        assert torch.equal(got["dres"], torch.where(got["y"] > 0, dy, torch.zeros_like(dy)))


@pytest.mark.benchmark
@pytest.mark.parametrize("rows", [1, 37, 4099])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("C", CHANNELS + (MAX_CHANNELS,))
def test_kernel_matches_the_plain_version_and_float64(C, residual, rows):
    _check_kernel((rows, C), residual, seed=rows + C)


@pytest.mark.benchmark
@pytest.mark.parametrize("label,shape,residual", CELL_SHAPES, ids=[s[0] for s in CELL_SHAPES])
def test_kernel_matches_the_plain_version_at_the_cells_shapes(label, shape, residual):
    _check_kernel(shape, residual, seed=3)
    torch.cuda.empty_cache()


@pytest.mark.benchmark
@pytest.mark.parametrize("residual", [False, True])
def test_two_runs_give_the_same_bits(residual):
    dev = _card()
    runs = [_kernel_run((3, 35, 17, 64), residual, seed=5, dev=dev)[0] for _ in range(2)]
    for key, a in runs[0].items():
        if a is not None:
            assert torch.equal(a, runs[1][key]), key


@pytest.mark.benchmark
def test_one_launch_a_site_counted_as_the_profiler_counts_them():
    dev = _card()
    blk = ResBlock(64, torch.Generator().manual_seed(0)).to(dev)
    x = torch.randn(8, 6, 6, 64, device=dev)
    before = cn.channel_norm.launches
    with torch.no_grad():
        blk(x)
    assert cn.channel_norm.launches == before + 2  # two sites, one launch each
    profiling.counters.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        blk(x.clone().requires_grad_()).sum().backward()
        torch.cuda.synchronize()
    counted = profiling.counters.pop("channel_norm.bytes")
    # two forwards, two backwards of two launches each
    assert cn.channel_norm.launches == before + 2 + 6 and len(counted) == 6
    traced = sum(1 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA and "channel_norm_" in e.name)
    assert traced == 6
    rows = 8 * 6 * 6
    assert counted[:2] == [4 * (rows * 64 * 2 + 128), 4 * (rows * 64 * 3 + 128)]
