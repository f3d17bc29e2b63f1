"""Port vs JAX: the conv stack (lightzero_tpu_torch/models/common.py against
the flax ResBlock, DownSample and conv representation, dynamics and
prediction networks), the conv branch of every model family that has one
(MuZero, EfficientZero, Stochastic MuZero, Sampled MuZero, Sampled
EfficientZero), the conv maps of utils/params_import.py both ways, one conv
MuZero learn step, the Atari and DMC widths, and the committed Space
Invaders EfficientZero params.

Weights are flax's init perturbed from a numpy seed (so that zero-init last
layers and unit LayerNorm scales become informative), carried across by the
importer. Inputs are numpy-seeded. Outputs agree to 1e-5 relative and
absolute (float32 convolutions, matmuls and LayerNorm statistics summed in
another order), except where stated.
"""
import jax
import jax.numpy as jnp
import flax.linen as fnn
import numpy as np
import pytest
import torch

from lightzero_tpu.config import Config as JaxConfig
from lightzero_tpu.config.core import deep_merge as jax_deep_merge
from lightzero_tpu.models import common as jax_common
from lightzero_tpu.models.efficientzero import EfficientZeroModel as JaxEZ
from lightzero_tpu.models.muzero import MuZeroModel as JaxMuZero
from lightzero_tpu.models.sampled_efficientzero import SampledEfficientZeroModel as JaxSEZ
from lightzero_tpu.models.sampled_muzero import SampledMuZeroModel as JaxSMZ
from lightzero_tpu.models.stochastic_muzero import StochasticMuZeroModel as JaxStoch
from lightzero_tpu.policy.muzero import MuZeroPolicy as JaxMuZeroPolicy
from lightzero_tpu.policy.muzero import TrainState as JaxTrainState
from lightzero_tpu_torch.config import Config
from lightzero_tpu_torch.models import (
    EfficientZeroModel,
    MuZeroModel,
    SampledEfficientZeroModel,
    SampledMuZeroModel,
    StochasticMuZeroModel,
)
from lightzero_tpu_torch.models import common
from lightzero_tpu_torch.policy import MuZeroPolicy
from lightzero_tpu_torch.utils.params_import import (
    _conv_port_name,
    flax_to_state_dict,
    state_dict_to_flax,
)
from test_torch_learn import PARAM_ATOL, SMALL_RMS, as_jax_batch, as_port_batch, flat

pytestmark = pytest.mark.unittest

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs several test processes at once: one intra-op thread
    each keeps them from fighting over the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def perturb(params, seed: int, scale: float = 0.1):
    """Every leaf plus numpy-seeded noise of std ``scale``, as numpy."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + (rng.standard_normal(np.shape(x)) * scale).astype(np.float32),
        params)


def close(got, exp, tol=TOL, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(exp), rtol=tol, atol=tol, err_msg=what)


def image(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------------ blocks


@pytest.mark.parametrize("size,stride", [(8, 1), (9, 1), (8, 2), (9, 2), (10, 2)])
def test_same_padding_matches_flax(size, stride):
    """flax SAME pads (0, 1) with stride 2 on an even size, (1, 1) on an
    odd one; the port's ConvNHWC pads the same, explicitly."""
    x = image(size, (2, size, size, 3))
    conv = fnn.Conv(5, (3, 3), strides=(stride, stride), padding="SAME", use_bias=False)
    params = perturb(conv.init(jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    exp = conv.apply(params, jnp.asarray(x))
    port = common.ConvNHWC(3, 5, 3, stride)
    port.weight.data = torch.from_numpy(params["params"]["kernel"].transpose(3, 2, 0, 1).copy())
    got = port(torch.from_numpy(x))
    assert got.shape == exp.shape == (2, -(-size // stride), -(-size // stride), 5)
    close(got, exp)
    expected_pad = {(8, 1): (1, 1), (9, 1): (1, 1), (8, 2): (0, 1), (9, 2): (1, 1), (10, 2): (0, 1)}
    assert common.same_padding(size, 3, stride) == expected_pad[(size, stride)]


def test_heads_flatten_in_hwc_order():
    """conv_reduce flattens the NHWC map as flax's reshape(B, -1) does, not
    in the (c, h, w) order of an NCHW flatten."""
    conv, norm = common.ConvNHWC(4, 3, 1), torch.nn.LayerNorm(3, eps=1e-6)
    x = torch.from_numpy(image(0, (2, 5, 6, 4)))
    got = common.conv_reduce(conv, norm, x)
    y = torch.relu(norm(conv(x))).detach().numpy()
    np.testing.assert_array_equal(got.detach().numpy(), y.reshape(2, -1))
    assert not np.array_equal(got.detach().numpy(), y.transpose(0, 3, 1, 2).reshape(2, -1))


def _load_block(port: torch.nn.Module, params) -> None:
    """Carry a flax block's params into the port's block through the conv
    map (the block posing as a model's ``_repr``)."""
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(params["params"])}
    sd = {}
    for key, value in flat.items():
        if key.endswith("kernel"):
            value = value.transpose(3, 2, 0, 1) if value.ndim == 4 else value.T
        name = _conv_port_name(f"_repr/{key}").split(".", 1)[1]
        sd[name] = torch.from_numpy(np.ascontiguousarray(value))
    port.load_state_dict(sd)


BLOCKS = {
    "res_block": (lambda: jax_common.ResBlock(8), lambda: common.ResBlock(8), [(2, 6, 6, 8)]),
    "downsample_even": (lambda: jax_common.DownSample(8), lambda: common.DownSample(3, 8),
                        [(2, 16, 16, 3)]),
    "downsample_odd": (lambda: jax_common.DownSample(8), lambda: common.DownSample(3, 8),
                       [(2, 21, 19, 3)]),
    "representation": (lambda: jax_common.RepresentationNetworkConv(8, 1, downsample=False),
                       lambda: common.RepresentationNetworkConv(3, 8, 1, downsample=False),
                       [(2, 6, 6, 3)]),
    "representation_downsample": (
        lambda: jax_common.RepresentationNetworkConv(8, 2, downsample=True),
        lambda: common.RepresentationNetworkConv(3, 8, 2, downsample=True), [(2, 16, 16, 3)]),
    "dynamics": (lambda: jax_common.DynamicsNetworkConv(8, 1, reward_support_size=11),
                 lambda: common.DynamicsNetworkConv(8, 3, 36, 1, reward_support_size=11),
                 [(2, 6, 6, 8), (2, 6, 6, 3)]),
    "prediction": (lambda: jax_common.PredictionNetworkConv(4, 11, 2, 8),
                   lambda: common.PredictionNetworkConv(4, 8, 36, 11, 2), [(2, 6, 6, 8)]),
}


@pytest.mark.parametrize("name", list(BLOCKS))
def test_block_matches_flax(name):
    make_flax, make_port, shapes = BLOCKS[name]
    xs = [image(i + 3, s) for i, s in enumerate(shapes)]
    module = make_flax()
    params = perturb(module.init(jax.random.PRNGKey(0), *map(jnp.asarray, xs)), 2)
    exp = module.apply(params, *map(jnp.asarray, xs))
    port = make_port()
    _load_block(port, params)
    with torch.no_grad():
        got = port(*map(torch.from_numpy, xs))
    for g, e in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(exp)):
        assert g.shape == e.shape
        close(g, e, what=name)


# ----------------------------------------------------------- model families

SMALL = dict(observation_shape=(6, 6, 3), model_type="conv", num_channels=8, num_res_blocks=1,
             downsample=False, value_support_size=11, reward_support_size=11)
FAMILIES = {
    "muzero": (JaxMuZero, MuZeroModel,
               dict(action_space_size=3, self_supervised_learning_loss=True)),
    "muzero_not_one_hot": (JaxMuZero, MuZeroModel,
                           dict(action_space_size=3, discrete_action_encoding_type="not_one_hot",
                                self_supervised_learning_loss=True)),
    "muzero_downsample": (JaxMuZero, MuZeroModel,
                          dict(action_space_size=3, observation_shape=(16, 16, 3),
                               downsample=True, num_res_blocks=2)),
    "efficientzero": (JaxEZ, EfficientZeroModel, dict(action_space_size=4, lstm_hidden_size=12)),
    "stochastic_muzero": (JaxStoch, StochasticMuZeroModel,
                          dict(action_space_size=3, chance_space_size=5, latent_state_dim=12)),
    "sampled_muzero": (JaxSMZ, SampledMuZeroModel, dict(action_space_size=2)),
    "sampled_muzero_discrete": (JaxSMZ, SampledMuZeroModel,
                                dict(action_space_size=3, continuous_action_space=False)),
    "sampled_efficientzero": (JaxSEZ, SampledEfficientZeroModel,
                              dict(action_space_size=2, lstm_hidden_size=12)),
}


def family_models(name, small=SMALL, seed=0, scale=0.1):
    jax_cls, port_cls, extra = FAMILIES[name]
    cfg = dict(small, **extra)
    flax_model = jax_cls.from_config(JaxConfig(cfg))
    params = perturb(flax_model.init_params(jax.random.PRNGKey(seed)), seed + 1, scale)
    port = port_cls.from_config(Config(cfg))
    port.load_state_dict(flax_to_state_dict(params))
    return flax_model, params, port.eval(), cfg


def as_dict(out) -> dict:
    return out._asdict() if hasattr(out, "_asdict") else dict(out)


def assert_outputs_close(got, exp, tol=TOL, what=""):
    got, exp = as_dict(got), as_dict(exp)
    for key, value in exp.items():
        if key == "reward_hidden":
            for g, e in zip(got[key], value):
                close(g, e, tol, f"{what} {key}")
            continue
        assert got[key].shape == value.shape, (what, key)
        close(got[key], value, tol, f"{what} {key}")


def actions_for(name, cfg, B, rng):
    if "sampled" in name and cfg.get("continuous_action_space", True):
        return rng.uniform(-1, 1, (B, cfg["action_space_size"])).astype(np.float32)
    return rng.integers(0, cfg["action_space_size"], B).astype(np.int32)


def inference_matches_flax(name, flax_model, params, port, cfg, B, seed, tol=TOL):
    """Initial inference on seeded images, then one recurrent step from the
    flax root latent (and its LSTM state) with seeded actions."""
    cls = type(flax_model)
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal((B, *cfg["observation_shape"])).astype(np.float32)
    exp0 = flax_model.apply(params, jnp.asarray(obs), method=cls.initial_inference)
    with torch.no_grad():
        got0 = port.initial_inference(torch.from_numpy(obs))
    assert_outputs_close(got0, exp0, tol, f"{name} initial")
    exp0 = as_dict(exp0)
    latent = np.asarray(exp0["latent_state"])
    action = actions_for(name, cfg, B, rng)
    args = [latent, action]
    if "reward_hidden" in exp0:
        hidden = tuple(rng.standard_normal(np.shape(h)).astype(np.float32) * 0.5
                       for h in exp0["reward_hidden"])
        args = [latent, hidden, action]
    jax_args = jax.tree_util.tree_map(jnp.asarray, args)
    port_args = jax.tree_util.tree_map(torch.from_numpy, args)
    exp1 = flax_model.apply(params, *jax_args, method=cls.recurrent_inference)
    with torch.no_grad():
        got1 = port.recurrent_inference(*port_args)
    assert_outputs_close(got1, exp1, tol, f"{name} recurrent")
    return obs, latent, action


@pytest.mark.parametrize("name", list(FAMILIES))
def test_conv_family_matches_flax(name):
    flax_model, params, port, cfg = family_models(name)
    obs, latent, action = inference_matches_flax(name, flax_model, params, port, cfg, 5, 7)
    if name != "stochastic_muzero":
        return
    # the chance step from the afterstate, and the conv chance encoder over
    # the observation pair stacked on the channel axis (a stride-2 SAME
    # conv on a 6 x 6 grid: padded (0, 1))
    exp = flax_model.apply(params, jnp.asarray(latent), jnp.asarray(action % 5), True,
                           method=JaxStoch.recurrent_inference)
    with torch.no_grad():
        got = port.recurrent_inference(torch.from_numpy(latent),
                                       torch.from_numpy(action % 5), True)
    assert_outputs_close(got, exp, what="chance step")
    pair = np.concatenate([obs, image(9, obs.shape)], axis=-1)
    exp = flax_model.apply(params, jnp.asarray(pair), method=JaxStoch.chance_encode)
    with torch.no_grad():
        got = port.chance_encode(torch.from_numpy(pair))
    for g, e in zip(got, exp):
        close(g, e, what="chance_encode")


@pytest.mark.parametrize("name", list(FAMILIES))
def test_conv_params_import_covers_the_model_both_ways(name):
    """Every flax leaf has a port tensor of its shape and back: the reverse
    map gives the flax tree leaf for leaf, and the import of that gives the
    port's state_dict again."""
    _, params, port, _ = family_models(name)
    sd = flax_to_state_dict(params)
    assert set(sd) == set(port.state_dict())
    for key, value in port.state_dict().items():
        assert sd[key].shape == value.shape, key
    back = state_dict_to_flax(port.state_dict())
    exp = jax.tree_util.tree_leaves_with_path(params)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(exp)
    for path, leaf in exp:
        np.testing.assert_array_equal(got[path], np.asarray(leaf), err_msg=str(path))
    again = flax_to_state_dict(back)
    assert all(torch.equal(again[k], v) for k, v in port.state_dict().items())


def test_conv_params_import_refuses_unknown_parameters():
    _, params, _, _ = family_models("muzero")
    bad = {"params": dict(params["params"], _extra={"Conv_0": {"kernel": np.zeros((1, 1, 2, 2))}})}
    with pytest.raises(KeyError, match="_extra"):
        flax_to_state_dict(bad)
    with pytest.raises(KeyError, match="extra"):
        state_dict_to_flax({"extra.conv.0.weight": torch.zeros(2, 2, 1, 1)})


def test_conv_default_init_is_flax_like():
    """lecun-normal conv kernels with fan-in kh kw c_in, no conv bias, zero
    last layers of the heads, LayerNorm eps 1e-6."""
    port = MuZeroModel.from_config(Config(dict(SMALL, action_space_size=3, num_channels=32)),
                                   torch.Generator().manual_seed(0))
    w = port.representation_network.res[0].conv[0].weight  # 3 x 3 x 32 -> 32
    fan_in = 3 * 3 * 32
    assert abs(w.std().item() - fan_in ** -0.5) < 0.01 * fan_in ** -0.5 * 10
    assert w.abs().max().item() <= 2 * fan_in ** -0.5 / 0.8796 + 1e-6
    assert not [n for n, _ in port.named_parameters() if "conv" in n and n.endswith("bias")]
    for mlp in (*port.prediction_network.mlp, *port.dynamics_network.mlp):
        assert not mlp.dense[-1].weight.any()
    assert port.representation_network.norm[0].eps == 1e-6


# -------------------------------------------------------------- learn step

CONV_POLICY = dict(
    model=dict(observation_shape=(6, 6, 3), action_space_size=3, model_type="conv",
               num_channels=8, num_res_blocks=1, downsample=False, support_scale=5,
               self_supervised_learning_loss=True, proj_hid=64, proj_out=64, pred_hid=32,
               pred_out=64),
    num_simulations=4, batch_size=32, learning_rate=0.003, ssl_loss_weight=2.0,
    optim_type="Adam", target_update_freq=2,
)


def test_conv_learn_step_matches_jax():
    """One learn step of conv MuZero (SSL on) from the same params on the
    same batch, held as tests/test_torch_learn.py holds the MLP one: logs to
    1e-5 relative, params to 1e-6 where Adam's input (the clipped gradient
    plus wd * p) has an RMS above 3e-5, and also where the loss's gradient
    is exactly zero in JAX (rows of the heads' first Dense whose input
    channel the relu zeroes across the batch, about a third of those
    rows: there both packages feed Adam wd * p alone), and to 2 lr
    elsewhere (under a quarter of the elements); the priorities, values after
    the inverse transform, to 1e-4 relative (the support's expectation
    summed in another order, amplified by the transform's slope near
    |v| = 8: ROADMAP queue 3's deliberate differences)."""
    jax_policy = JaxMuZeroPolicy(jax_deep_merge(JaxMuZeroPolicy.default_config(), CONV_POLICY))
    params = perturb(jax_policy.model.init_params(jax.random.PRNGKey(0)), 1)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    jax_state = JaxTrainState(params=params, target_params=jax.tree_util.tree_map(jnp.copy, params),
                              opt_state=jax_policy.optimizer.init(params),
                              train_iter=jnp.zeros((), jnp.int32))
    port = MuZeroPolicy(CONV_POLICY, device="cpu")
    port.model.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    state = port.init_train_state()

    rng = np.random.default_rng(0)
    B, K, A = 32, 5, 3
    steps_left = rng.integers(0, K + 1, B)
    mask = (np.arange(K)[None] < steps_left[:, None]).astype(np.float32)
    policy = rng.dirichlet(np.ones(A), (B, K + 1)).astype(np.float32)
    b = dict(obs=(rng.random((B, K + 1, 6, 6, 3)) < 0.2).astype(np.float32),
             actions=rng.integers(0, A, (B, K)).astype(np.int64), mask=mask,
             target_reward=rng.uniform(-2, 2, (B, K)).astype(np.float32),
             target_value=rng.uniform(-8, 8, (B, K + 1)).astype(np.float32),
             target_policy=policy, weights=rng.uniform(0.2, 1.0, B).astype(np.float32))
    grads = flat(jax.grad(lambda p: jax_policy._loss_fn(p, as_jax_batch(b))[0])(params))
    g_norm = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2)) for g in grads.values()))
    scale = min(1.0, float(jax_policy.cfg.grad_clip_value) / g_norm)
    p0 = flat(params)
    wd = float(jax_policy.cfg.weight_decay)
    jax_new, jax_logs, jax_priority = jax_policy.forward_learn(jax_state, as_jax_batch(b))
    new, logs, priority = port.forward_learn(state, as_port_batch(b))
    assert set(logs) == set(jax_logs)
    for key, exp in jax_logs.items():
        np.testing.assert_allclose(float(logs[key]), float(exp), rtol=1e-5, atol=1e-6, err_msg=key)
    assert float(jax_logs["consistency_loss"]) != 0.0  # the SSL branch ran
    np.testing.assert_allclose(priority.numpy(), np.asarray(jax_priority), rtol=1e-4, atol=1e-5)
    assert new.train_iter == 1
    got = flat(state_dict_to_flax(port.model.state_dict()))
    exp = flat(jax_new.params)
    assert set(got) == set(exp)
    loose = 0
    for k, e in exp.items():
        sensitive = (np.abs(scale * grads[k] + wd * p0[k]) <= SMALL_RMS) & (grads[k] != 0)
        np.testing.assert_allclose(got[k][~sensitive], e[~sensitive], rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)
        np.testing.assert_allclose(got[k], e, rtol=0, atol=2 * 0.003, err_msg=k)
        loose += int(sensitive.sum())
    total = sum(e.size for e in exp.values())
    assert loose <= total // 4, f"{loose} of {total} elements held only to 2 lr"


# ------------------------------------------------------------ wide configs

WIDE = {
    # zoo/atari/config/atari_muzero_config.py's model: 96 x 96 x 12 (4
    # stacked RGB frames), 64 channels, the DownSample pyramid to 6 x 6
    "atari_muzero": ("muzero", dict(observation_shape=(96, 96, 12), num_channels=64,
                                    downsample=True, value_support_size=601,
                                    reward_support_size=601), dict(action_space_size=6)),
    # zoo/atari/config/atari_stochastic_muzero_config.py
    "atari_stochastic_muzero": ("stochastic_muzero",
                                dict(observation_shape=(96, 96, 12), num_channels=64,
                                     downsample=True, value_support_size=601,
                                     reward_support_size=601),
                                dict(action_space_size=6, chance_space_size=4,
                                     latent_state_dim=256)),
    # zoo/dmc2gym/config/dmc2gym_pixels_sez_config.py: 84 x 84 x 3 -> 5 x 5
    "dmc_sampled_efficientzero": ("sampled_efficientzero",
                                  dict(observation_shape=(84, 84, 3), num_channels=64,
                                       downsample=True, value_support_size=601,
                                       reward_support_size=601),
                                  dict(action_space_size=1, lstm_hidden_size=256)),
}


@pytest.mark.parametrize("name", list(WIDE))
def test_wide_config_matches_flax(name):
    """The Atari and DMC configs' widths at B=2: one initial and one
    recurrent inference (weights perturbed by 0.02, the sums being longer);
    outputs to 1e-4 (sums of up to 147,456 float32 terms in another
    order)."""
    family, wide, extra = WIDE[name]
    small = dict(SMALL, **wide)
    jax_cls, port_cls, _ = FAMILIES[family]
    FAMILIES[name] = (jax_cls, port_cls, extra)
    try:
        flax_model, params, port, cfg = family_models(name, small=small, scale=0.02)
        inference_matches_flax(name, flax_model, params, port, cfg, 2, 11, tol=1e-4)
    finally:
        del FAMILIES[name]


# ------------------------------------------------- committed trained params

SI_CKPT = "data_ez/space_invaders_grid_ez_v3_seed0/ckpt/params_best"


def test_committed_space_invaders_params_match_flax_in_the_port():
    """The conv EfficientZero params the JAX package trained on the Space
    Invaders grid (166 leaves, 17.0M elements with the target copy) load
    into the port through the importer, and its initial and recurrent
    inference equal flax's on observations of the port's env."""
    import json
    import pathlib

    from lightzero_tpu.utils.checkpoint import load_checkpoint
    from lightzero_tpu_torch.envs import SpaceInvadersGridEnv

    root = pathlib.Path(__file__).resolve().parent.parent
    restored = load_checkpoint(str(root / SI_CKPT))
    leaves = jax.tree_util.tree_leaves(restored)
    assert len(leaves) == 166 and sum(np.size(x) for x in leaves) == 17_046_044
    total = json.loads((root / SI_CKPT).parent.parent.joinpath("total_config.json").read_text())
    cfg = dict(total["policy"]["model"], value_support_size=101, reward_support_size=101)
    cfg["observation_shape"] = tuple(cfg["observation_shape"])
    flax_model = JaxEZ.from_config(JaxConfig(cfg))
    params = jax.tree_util.tree_map(np.asarray, restored["params"])
    port = EfficientZeroModel.from_config(Config(cfg)).eval()
    port.load_state_dict(flax_to_state_dict(params))

    env = SpaceInvadersGridEnv()
    g = torch.Generator().manual_seed(0)
    state, obs = env.reset(6, g)
    frames = []
    for _ in range(12):
        step = env.step(state, torch.randint(0, 4, (6,), generator=g), g)
        state = step.state
        frames.append(step.obs)
    obs = torch.cat(frames[5::6]).numpy()  # 12 observations
    exp0 = flax_model.apply(params, jnp.asarray(obs), method=JaxEZ.initial_inference)
    with torch.no_grad():
        got0 = port.initial_inference(torch.from_numpy(obs))
    assert_outputs_close(got0, exp0, what="initial")
    action = np.arange(12, dtype=np.int32) % 4
    hidden = exp0.reward_hidden
    exp1 = flax_model.apply(params, exp0.latent_state, hidden, jnp.asarray(action),
                            method=JaxEZ.recurrent_inference)
    exp2 = flax_model.apply(params, exp1.latent_state, exp1.reward_hidden,
                            jnp.asarray(action[::-1].copy()), method=JaxEZ.recurrent_inference)
    with torch.no_grad():
        got1 = port.recurrent_inference(got0.latent_state, got0.reward_hidden,
                                        torch.from_numpy(action))
        got2 = port.recurrent_inference(got1.latent_state, got1.reward_hidden,
                                        torch.from_numpy(action[::-1].copy()))
    assert_outputs_close(got1, exp1, what="recurrent 1")
    assert_outputs_close(got2, exp2, what="recurrent 2")
    assert float(got0.policy_logits.std()) > 0  # trained heads, not the zero init
