"""Port vs JAX: the HarmonyDream loss weights (lightzero_tpu_torch/models/muzero.py
and policy/muzero.py against lightzero_tpu/models/muzero.py:69-82 and
lightzero_tpu/policy/muzero.py:342-356).

- With ``harmony_balance`` the model holds three 0-d scalars,
  ``harmony_{policy,value,reward}``, zero at init as in flax; without it, none.
  params_import carries them both ways.
- Three learn steps from the same flax params (the scalars perturbed off
  zero), carried across with params_import, on the same numpy-seeded
  batches with the SSL loss on: every logged term to 1e-5 relative (the
  consistency loss, a sum of K cosines a sample that can cancel near zero,
  to 1e-5 x K absolute), the priorities to 1e-5, the params to test_torch_learn.py's tolerances (1e-6
  where the gradients Adam saw are not near zero, 2 lr elsewhere), and the
  three scalars move.
- The types whose JAX policies inherit MuZero's loss (Gumbel MuZero,
  MuZero-Context, the muzero_multitask type) build the scalars in both
  packages and move them in a port learn step. The types whose JAX policies
  replace the loss build no scalars in JAX and train with the fixed weights
  without a word; the port refuses them (ROADMAP queue 3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightzero_tpu.config.core import deep_merge as jax_deep_merge
from lightzero_tpu.policy.muzero import MuZeroPolicy as JaxMuZeroPolicy
from lightzero_tpu.policy.muzero import TrainState as JaxTrainState
from lightzero_tpu.utils.registry import POLICY_REGISTRY
from lightzero_tpu_torch.entry.train_muzero import POLICIES
from lightzero_tpu_torch.models import MuZeroModel
from lightzero_tpu_torch.policy import MuZeroMTPolicy, MuZeroPolicy
from lightzero_tpu_torch.utils.params_import import flax_to_state_dict, state_dict_to_flax
from test_torch_learn import (
    LOG_RTOL,
    SMALL,
    LR,
    SMALL_RMS,
    _check_logs,
    as_jax_batch,
    as_port_batch,
    assert_params_close,
    flat,
    gradients_seen,
    random_batch,
)
from test_torch_model import perturbed_params

pytestmark = pytest.mark.unittest

HARMONY = ("harmony_policy", "harmony_value", "harmony_reward")
HARMONY_SMALL = dict(SMALL, model=dict(SMALL["model"], harmony_balance=True))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_policy():
    return JaxMuZeroPolicy(jax_deep_merge(JaxMuZeroPolicy.default_config(), HARMONY_SMALL))


def test_the_scalars_exist_only_with_harmony_balance(jax_policy):
    port = MuZeroPolicy(HARMONY_SMALL, device="cpu")
    scalars = {n: p for n, p in port.model.named_parameters() if n.startswith("harmony")}
    assert sorted(scalars) == sorted(HARMONY)
    assert all(p.shape == () and float(p.detach()) == 0.0 for p in scalars.values())
    params = jax_policy.model.init_params(jax.random.PRNGKey(0))["params"]
    assert all(np.asarray(params[k]).shape == () and float(params[k]) == 0.0 for k in HARMONY)
    plain = MuZeroPolicy(SMALL, device="cpu")
    assert not any(n.startswith("harmony") for n, _ in plain.model.named_parameters())
    assert not hasattr(plain.model, "harmony_policy")
    # both ways through params_import
    back = state_dict_to_flax(port.model.state_dict())["params"]
    assert all(back[k].shape == () for k in HARMONY)
    conv = MuZeroModel.from_config(dict(observation_shape=(4, 4, 2), action_space_size=2,
                                        model_type="conv", num_channels=4, downsample=False,
                                        harmony_balance=True))
    sd = flax_to_state_dict(state_dict_to_flax(conv.state_dict()))
    assert set(sd) == set(conv.state_dict())


def harmony_states(jax_policy, seed):
    params = jax.tree_util.tree_map(jnp.asarray, perturbed_params(jax_policy.model, seed))
    assert all(float(params["params"][k]) != 0.0 for k in HARMONY)
    jax_state = JaxTrainState(params=params, target_params=jax.tree_util.tree_map(jnp.copy, params),
                              opt_state=jax_policy.optimizer.init(params),
                              train_iter=jnp.zeros((), jnp.int32))
    port = MuZeroPolicy(HARMONY_SMALL, device="cpu")
    port.model.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    return jax_state, port, port.init_train_state()


def check_step_logs(port, logs, jax_logs, priority, jax_priority):
    # the consistency loss sums K cosines a sample, each within [-1, 1]:
    # held to 1e-5 of that scale, since their sum can cancel near zero
    np.testing.assert_allclose(float(logs["consistency_loss"]),
                               float(jax_logs["consistency_loss"]), rtol=0,
                               atol=LOG_RTOL * port.num_unroll_steps)
    _check_logs({k: v for k, v in logs.items() if k != "consistency_loss"},
                {k: v for k, v in jax_logs.items() if k != "consistency_loss"})
    np.testing.assert_allclose(priority.numpy(), np.asarray(jax_priority), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_learn_step_matches_jax(jax_policy, seed):
    jax_state, port, state = harmony_states(jax_policy, seed + 4)
    b = random_batch(20 + seed)
    seen = gradients_seen(jax_policy, jax_state.params, as_jax_batch(b))
    jax_state, jax_logs, jax_priority = jax_policy.forward_learn(jax_state, as_jax_batch(b))
    state, logs, priority = port.forward_learn(state, as_port_batch(b))
    check_step_logs(port, logs, jax_logs, priority, jax_priority)
    assert_params_close(port.model, jax_state.params, seen)
    for k in HARMONY:
        assert sensitive_free(seen, k)
        np.testing.assert_allclose(float(getattr(port.model, k).detach()),
                                   float(jax_state.params["params"][k]), rtol=0, atol=1e-6)


def sensitive_free(seen, name):
    """Whether the scalar's Adam input exceeded SMALL_RMS (it is held to 1e-6)."""
    sumsq, steps = seen
    return bool(np.sqrt(sumsq["params/" + name] / steps) > SMALL_RMS)


def test_three_learn_steps_move_the_scalars_as_jax(jax_policy):
    """Three steps in a row: the loss terms the scalars weigh and the three
    scalars stay as close as after one; the other params, which carry the
    earlier steps' rounding into later gradients, within 2 lr."""
    jax_state, port, state = harmony_states(jax_policy, 7)
    start = {k: float(getattr(port.model, k).detach()) for k in HARMONY}
    for step in range(3):
        b = as_jax_batch(random_batch(30 + step))
        jax_state, jax_logs, jax_priority = jax_policy.forward_learn(jax_state, b)
        state, logs, _ = port.forward_learn(state, as_port_batch(random_batch(30 + step)))
        for k in ("total_loss", "policy_loss", "value_loss", "reward_loss"):
            np.testing.assert_allclose(float(logs[k]), float(jax_logs[k]), rtol=LOG_RTOL,
                                       err_msg=k)
        got = flat(state_dict_to_flax(port.model.state_dict()))
        for k, exp in flat(jax_state.params).items():
            np.testing.assert_allclose(got[k], exp, rtol=0, atol=2 * LR, err_msg=k)
        for k in HARMONY:
            np.testing.assert_allclose(float(getattr(port.model, k).detach()),
                                       float(jax_state.params["params"][k]), rtol=0, atol=1e-6)
    assert all(float(getattr(port.model, k).detach()) != start[k] for k in HARMONY)
    assert state.train_iter == int(jax_state.train_iter) == 3


def _learn_moves_the_scalars(policy, batch):
    state = policy.init_train_state()
    before = {k: float(getattr(policy.model, k).detach()) for k in HARMONY}
    state, logs, _ = policy.forward_learn(state, batch)
    assert all(float(getattr(policy.model, k).detach()) != before[k] for k in HARMONY)
    return logs


@pytest.mark.parametrize("policy_type", ["gumbel_muzero", "muzero_context"])
def test_the_variants_that_inherit_the_loss_take_the_scalars(policy_type):
    import importlib

    importlib.import_module(f"lightzero_tpu.policy.{policy_type}")  # registers it
    cls = POLICY_REGISTRY.get(policy_type)
    small = dict(HARMONY_SMALL, type=policy_type)
    jax_params = cls(jax_deep_merge(cls.default_config(), small)).model.init_params(
        jax.random.PRNGKey(0))["params"]
    assert set(HARMONY) <= set(jax_params)
    port = POLICIES[policy_type](small, device="cpu")
    _learn_moves_the_scalars(port, as_port_batch(random_batch(5)))


def test_the_multitask_muzero_adds_the_regularizer():
    from lightzero_tpu.policy.multitask import MuZeroMTPolicy as JaxMuZeroMTPolicy
    from lightzero_tpu_torch.policy.multitask import attach_task_fields

    cfg = dict(HARMONY_SMALL, task_num=2, model=dict(HARMONY_SMALL["model"], num_tasks=2))
    jax_params = JaxMuZeroMTPolicy(jax_deep_merge(JaxMuZeroMTPolicy.default_config(), cfg)
                                   ).model.init_params(jax.random.PRNGKey(0))["params"]
    assert set(HARMONY) <= set(jax_params)
    port = MuZeroMTPolicy(cfg, device="cpu")
    # the scalars start at 0: each of the three regularizer terms is log 2
    assert float(port._harmony_regularizer(port.model)) == pytest.approx(3 * np.log(2.0),
                                                                        rel=1e-6)
    batch = attach_task_fields(as_port_batch(random_batch(6)), np.arange(16) % 2, np.ones(2))
    logs = _learn_moves_the_scalars(port, batch)
    assert np.isfinite(float(logs["total_loss"]))
    plain = MuZeroMTPolicy(dict(SMALL, task_num=2, model=dict(SMALL["model"], num_tasks=2)),
                           device="cpu")
    assert float(plain._harmony_regularizer(plain.model)) == 0.0


IGNORED_BY_JAX = ["efficientzero", "stochastic_muzero", "sampled_muzero", "sampled_efficientzero",
                  "muzero_rnn_full_obs", "unizero", "sampled_unizero"]


@pytest.mark.parametrize("policy_type", IGNORED_BY_JAX)
def test_the_variants_whose_jax_loss_ignores_harmony_are_refused(policy_type):
    import importlib

    importlib.import_module(f"lightzero_tpu.policy.{policy_type}")  # registers it
    cls = POLICY_REGISTRY.get(policy_type)
    model = dict(observation_shape=4, action_space_size=2, latent_state_dim=8, support_scale=5,
                 lstm_hidden_size=8, embed_dim=16, num_heads=2, harmony_balance=True)
    small = dict(type=policy_type, model=model, num_simulations=2, num_of_sampled_actions=2)
    jax_policy = cls(jax_deep_merge(cls.default_config(), small))
    params = jax_policy.model.init_params(jax.random.PRNGKey(0))["params"]
    assert not set(HARMONY) & set(params)
    with pytest.raises(ValueError, match="harmony_balance"):
        POLICIES[policy_type](small, device="cpu")
