"""The slice end to end: the port's MuZeroPolicy.forward_eval against the JAX
policy's _forward_collect(deterministic=True) at the CartPole MuZero config
(full width, 25 simulations), on flax weights carried across by
params_import and perturbed from a numpy seed so that the heads are not
zero. Both searches use tie_break='first' (the JAX default 'noise' draws from
jax.random, which the port cannot reproduce).

Actions and visit counts must be equal; the searched and predicted values
agree to 1e-4 (the model agrees to 1e-5, and the inverse value transform
amplifies that, see test_torch_ops.py). Also the port's Evaluator on the CPU."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightzero_tpu.config.core import deep_merge as jax_deep_merge
from lightzero_tpu.policy.muzero import MuZeroPolicy as JaxMuZeroPolicy
from lightzero_tpu_torch import _build
from lightzero_tpu_torch.configs.cartpole_muzero import main_config
from lightzero_tpu_torch.envs import CartPoleEnv
from lightzero_tpu_torch.policy import MuZeroPolicy
from lightzero_tpu_torch.utils.params_import import flax_to_state_dict
from lightzero_tpu_torch.workers import Evaluator
from test_torch_model import perturbed_params
from zoo.classic_control.cartpole.config.cartpole_muzero_config import main_config as zoo_config

pytestmark = pytest.mark.unittest


def test_port_config_is_the_zoo_config():
    assert main_config.to_dict() == zoo_config.to_dict()


@pytest.fixture(scope="module")
def policies():
    jax_cfg = jax_deep_merge(JaxMuZeroPolicy.default_config(), zoo_config.policy)
    jax_policy = JaxMuZeroPolicy(jax_cfg)
    jax_policy.search_cfg = dataclasses.replace(jax_policy.search_cfg, tie_break="first")
    params = perturbed_params(jax_policy.model, 3)
    port = MuZeroPolicy(main_config.policy, device="cpu")
    port.model.load_state_dict(flax_to_state_dict(params))
    port.search_cfg = dataclasses.replace(port.search_cfg, tie_break="first")
    return jax_policy, params, port


def test_search_config_matches_jax(policies):
    jax_policy, _, port = policies
    for field in dataclasses.fields(port.search_cfg):
        assert getattr(port.search_cfg, field.name) == getattr(jax_policy.search_cfg, field.name)


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_eval_matches_jax(policies, seed):
    jax_policy, params, port = policies
    rng = np.random.default_rng(seed)
    obs = (rng.standard_normal((3, 4)) * np.array([0.5, 0.5, 0.1, 0.5])).astype(np.float32)
    legal = np.ones((3, 2), bool)
    exp = jax_policy.forward_eval(params, jax.random.PRNGKey(0), jnp.asarray(obs), jnp.asarray(legal))
    got = port.forward_eval(torch.from_numpy(obs), torch.from_numpy(legal))
    np.testing.assert_array_equal(got["action"].numpy(), np.asarray(exp["action"]))
    np.testing.assert_array_equal(got["visit_counts"].numpy(), np.asarray(exp["visit_counts"]))
    assert got["visit_counts"].sum(dim=1).tolist() == [25] * 3
    for key in ("searched_value", "predicted_value"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(exp[key]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["policy_logits"].numpy(), np.asarray(exp["policy_logits"]),
                               rtol=1e-5, atol=1e-5)


def test_forward_collect_searches_with_noise(policies):
    _, _, port = policies
    obs = torch.zeros((4, 4))
    out = port.forward_collect(obs, torch.ones((4, 2), dtype=torch.bool), temperature=0.25)
    assert out["visit_counts"].sum(dim=1).tolist() == [25] * 4
    assert set(out["action"].tolist()) <= {0, 1}


def test_evaluator_plays_episodes_on_cpu():
    cfg = dict(main_config.policy, num_simulations=4,
               model=dict(main_config.policy.model, latent_state_dim=16))
    policy = MuZeroPolicy(cfg, device="cpu")
    before = _build.launches["fused_traverse_launch"]
    ev = Evaluator(CartPoleEnv(max_episode_steps=6), policy, num_envs=3, seed=0, device="cpu")
    out = ev.eval()
    # 6 steps from near upright cannot fail: every episode is truncated at 6
    assert out["episode_returns"] == [6.0, 6.0, 6.0]
    assert out["env_steps"] == 6 and out["new_best"]
    assert _build.launches["fused_traverse_launch"] == before  # the CPU runs the plain version


def _three_action_policies(seed):
    cfg = dict(main_config.policy, num_simulations=8,
               model=dict(main_config.policy.model, action_space_size=3, latent_state_dim=32,
                          self_supervised_learning_loss=False))
    jax_policy = JaxMuZeroPolicy(jax_deep_merge(JaxMuZeroPolicy.default_config(), cfg))
    params = perturbed_params(jax_policy.model, seed)
    port = MuZeroPolicy(cfg, device="cpu", seed=seed)
    port.model.load_state_dict(flax_to_state_dict(params))
    return jax_policy, params, port, cfg


def test_pure_policy_eval_matches_jax_with_an_illegal_action():
    """collect_with_pure_policy under forward_eval: the argmax of the masked
    policy and its softmax, against JAX (probabilities to 1e-6)."""
    jax_policy, params, _, cfg = _three_action_policies(5)
    cfg = dict(cfg, collect_with_pure_policy=True)
    jax_policy = JaxMuZeroPolicy(jax_deep_merge(JaxMuZeroPolicy.default_config(), cfg))
    port = MuZeroPolicy(cfg, device="cpu")
    port.model.load_state_dict(flax_to_state_dict(params))
    rng = np.random.default_rng(6)
    obs = rng.standard_normal((16, 4)).astype(np.float32)
    legal = np.ones((16, 3), bool)
    legal[np.arange(16), rng.integers(0, 3, 16)] = False
    exp = jax_policy.forward_eval(params, jax.random.PRNGKey(0), jnp.asarray(obs), jnp.asarray(legal))
    before = _build.launches["fused_traverse_launch"]
    got = port.forward_eval(torch.from_numpy(obs), torch.from_numpy(legal))
    assert _build.launches["fused_traverse_launch"] == before  # no search in this mode
    np.testing.assert_array_equal(got["action"].numpy(), np.asarray(exp["action"]))
    assert legal[np.arange(16), got["action"].numpy()].all()
    np.testing.assert_allclose(got["visit_counts"].numpy(), np.asarray(exp["visit_counts"]),
                               rtol=1e-6, atol=1e-6)
    assert (got["visit_counts"].numpy()[~legal] == 0).all()
    np.testing.assert_allclose(got["distribution_entropy"].numpy(),
                               np.asarray(exp["distribution_entropy"]), rtol=1e-5, atol=1e-6)


def test_epsilon_greedy_collect():
    """The streams differ from JAX's, so: at epsilon=1 every action is legal
    and both legal actions of a row occur; at epsilon=0 the actions equal
    those of a call without epsilon from the same generator state."""
    _, _, port, _ = _three_action_policies(9)
    obs = torch.from_numpy(np.random.default_rng(10).standard_normal((64, 4)).astype(np.float32))
    legal = torch.ones((64, 3), dtype=torch.bool)
    legal[:, 1] = False
    out = port.forward_collect(obs, legal, temperature=0.25, epsilon=1.0)
    assert legal[torch.arange(64), out["action"]].all()
    assert set(out["action"].tolist()) == {0, 2}
    port.generator.manual_seed(11)
    plain = port.forward_collect(obs, legal, temperature=0.25)
    port.generator.manual_seed(11)
    eps0 = port.forward_collect(obs, legal, temperature=0.25, epsilon=0.0)
    assert torch.equal(plain["action"], eps0["action"])
    assert torch.equal(plain["visit_counts"], eps0["visit_counts"])
