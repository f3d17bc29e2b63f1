"""Port vs JAX: the MuZero MLP model (lightzero_tpu_torch/models against the
flax MuZeroModel) at the CartPole config's full width (latent 128, supports
of 601 atoms, 32-wide heads), on flax weights carried across by
utils/params_import.py, the SSL projector included.

The flax init zeroes every head's last layer, which would make all head
outputs 0; the weights are perturbed from a numpy seed first. Outputs agree
to 1e-5 (float32 matmuls and LayerNorm statistics summed in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightzero_tpu.config import Config as JaxConfig
from lightzero_tpu.models import MuZeroModel as JaxMuZeroModel
from lightzero_tpu_torch.config import Config
from lightzero_tpu_torch.models import MuZeroModel
from lightzero_tpu_torch.utils.params_import import flax_to_state_dict

pytestmark = pytest.mark.unittest

MODEL = dict(
    observation_shape=4, action_space_size=2, model_type="mlp", latent_state_dim=128,
    self_supervised_learning_loss=True, discrete_action_encoding_type="one_hot",
    norm_type="LN", value_support_size=601, reward_support_size=601,
)


def perturbed_params(flax_model, seed: int):
    """flax init, then every leaf plus numpy-seeded noise (so the zero-init
    last layers and unit LayerNorm scales become informative)."""
    params = flax_model.init_params(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + (rng.standard_normal(x.shape) * 0.1).astype(np.float32), params
    )


@pytest.fixture(scope="module")
def models():
    flax_model = JaxMuZeroModel.from_config(JaxConfig(MODEL))
    params = perturbed_params(flax_model, 0)
    port = MuZeroModel.from_config(Config(MODEL))
    port.load_state_dict(flax_to_state_dict(params))
    return flax_model, params, port.eval()


def _close(got, exp):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(exp), rtol=1e-5, atol=1e-5)


def test_params_import_covers_the_whole_model(models):
    _, params, port = models
    sd = flax_to_state_dict(params)
    assert set(sd) == set(port.state_dict())
    for k, v in port.state_dict().items():
        assert sd[k].shape == v.shape, k


def test_initial_inference_matches_flax(models):
    flax_model, params, port = models
    obs = np.random.default_rng(1).standard_normal((6, 4)).astype(np.float32)
    exp = flax_model.apply(params, jnp.asarray(obs), method=JaxMuZeroModel.initial_inference)
    with torch.no_grad():
        got = port.initial_inference(torch.from_numpy(obs))
    for field in ("value_logits", "reward_logits", "policy_logits", "latent_state"):
        _close(getattr(got, field), getattr(exp, field))


def test_recurrent_inference_matches_flax(models):
    flax_model, params, port = models
    rng = np.random.default_rng(2)
    latent = np.maximum(rng.standard_normal((6, 128)), 0).astype(np.float32)
    action = rng.integers(0, 2, 6).astype(np.int32)
    exp = flax_model.apply(params, jnp.asarray(latent), jnp.asarray(action),
                           method=JaxMuZeroModel.recurrent_inference)
    with torch.no_grad():
        got = port.recurrent_inference(torch.from_numpy(latent), torch.from_numpy(action))
    for field in ("value_logits", "reward_logits", "policy_logits", "latent_state"):
        _close(getattr(got, field), getattr(exp, field))


def test_params_import_refuses_unknown_parameters(models):
    _, params, _ = models
    bad = {"params": dict(params["params"], _extra={"Dense_0": {"kernel": np.zeros((2, 2))}})}
    with pytest.raises(KeyError, match="_extra"):
        flax_to_state_dict(bad)


def test_default_init_is_flax_like():
    port = MuZeroModel.from_config(Config(MODEL), torch.Generator().manual_seed(0))
    heads = (port.dynamics_network.reward_head, port.prediction_network.value_head,
             port.prediction_network.policy_head)
    for head in heads:  # last_linear_layer_init_zero
        assert not head.dense[-1].weight.any()
    w = port.representation_network.torso.dense[1].weight  # 128 -> 128, lecun normal
    assert abs(w.std().item() - (1 / 128) ** 0.5) < 0.01
    assert w.abs().max().item() <= 2 * (1 / 128) ** 0.5 / 0.8796 + 1e-6
    assert port.representation_network.torso.norm[0].eps == 1e-6


def test_state_dict_to_flax_inverts_the_import(models):
    """The reverse map gives back the flax tree, leaf for leaf (the SSL
    projector included), and a port state_dict round-trips through it."""
    from lightzero_tpu_torch.utils.params_import import state_dict_to_flax

    _, params, port = models
    back = state_dict_to_flax(port.state_dict())
    exp = jax.tree_util.tree_leaves_with_path(params)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(exp) and any("_proj" in str(path) for path, _ in exp)
    for path, leaf in exp:
        np.testing.assert_array_equal(got[path], np.asarray(leaf), err_msg=str(path))
    again = flax_to_state_dict(back)
    assert all(torch.equal(again[k], v) for k, v in port.state_dict().items())
    with pytest.raises(KeyError, match="extra"):
        state_dict_to_flax({"extra.0.weight": torch.zeros(2)})


def test_projector_matches_flax(models):
    flax_model, params, port = models
    latent = np.random.default_rng(3).standard_normal((5, 128)).astype(np.float32)
    for with_grad in (True, False):
        exp = flax_model.apply(params, jnp.asarray(latent), with_grad, method=JaxMuZeroModel.project)
        with torch.no_grad():
            got = port.project(torch.from_numpy(latent), with_grad)
        assert got.shape == (5, 1024)
        _close(got, exp)


def test_projector_exists_only_with_the_ssl_loss():
    port = MuZeroModel.from_config(Config(dict(MODEL, self_supervised_learning_loss=False)))
    assert port.projector is None
    assert not any(k.startswith("projector") for k in port.state_dict())


def test_scalar_action_encoding_and_residual_dynamics_match_flax():
    """discrete_action_encoding_type='not_one_hot' (action / A as one input)
    and res_connection_in_dynamics=True, in recurrent_inference."""
    cfg = dict(MODEL, discrete_action_encoding_type="not_one_hot", res_connection_in_dynamics=True,
               action_space_size=3, latent_state_dim=32, self_supervised_learning_loss=False)
    flax_model = JaxMuZeroModel.from_config(JaxConfig(cfg))
    params = perturbed_params(flax_model, 7)
    port = MuZeroModel.from_config(Config(cfg))
    port.load_state_dict(flax_to_state_dict(params))
    assert port.dynamics_network.torso.dense[0].in_features == 32 + 1
    rng = np.random.default_rng(8)
    latent = rng.standard_normal((6, 32)).astype(np.float32)
    action = rng.integers(0, 3, 6).astype(np.int32)
    exp = flax_model.apply(params, jnp.asarray(latent), jnp.asarray(action),
                           method=JaxMuZeroModel.recurrent_inference)
    with torch.no_grad():
        got = port.recurrent_inference(torch.from_numpy(latent), torch.from_numpy(action))
    for field in ("value_logits", "reward_logits", "policy_logits", "latent_state"):
        _close(getattr(got, field), getattr(exp, field))
