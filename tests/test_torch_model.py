"""Port vs JAX: the MuZero MLP model (lightzero_tpu_torch/models against the
flax MuZeroModel) at the CartPole config's full width (latent 128, supports
of 601 atoms, 32-wide heads), on flax weights carried across by
utils/params_import.py.

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
