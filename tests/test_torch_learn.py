"""Port vs JAX: the training half of the MuZero policy
(lightzero_tpu_torch/policy/muzero.py against lightzero_tpu/policy/muzero.py).

- The defaults and the learning-rate schedules equal the JAX policy's; the
  schedules are read on each side of the piecewise boundaries and past the
  cosine decay's steps (floats computed in float64 here and float32 by
  optax: 1e-6 relative).
- Each optimizer branch (SGD, Adam, AdamW, AdamW with its selective decay)
  takes 4 steps on the same gradients as the optax chain, with the global
  norm clip active on some steps: 1e-6 (float32 rounding of the same
  formulas in another order).
- One learn step from the same flax params, carried across with
  params_import, on the same numpy-seeded batch, with the SSL loss on as in
  the CartPole config (small widths): every logged term and the grad norm to
  1e-5 relative, the priorities to 1e-5, the new params to 2e-6 absolute.
  The gradients agree to 1e-7 absolute, but Adam's update is
  lr * m / (sqrt(v) + 1e-8), m and v running means of g and g^2, with g the
  clipped gradient plus the L2 term wd * p: a gradient error d moves it by
  about lr * d / sqrt(v), and by up to 2 lr where g is near zero (at the
  first step the update is about lr * sign(g)). So the new params are held
  to 1e-6 where the RMS of the g Adam has seen exceeds 3e-5, and to 2 lr
  elsewhere (those elements are counted and must be under 25 %: zero
  gradients of dead units meet a decay term wd * p below 3e-5).
- Three steps with target_update_freq=2: the target copy at step 2 only,
  and the same tolerances on the params after each step.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lightzero_tpu.config.core import deep_merge as jax_deep_merge
from lightzero_tpu.policy.muzero import MuZeroPolicy as JaxMuZeroPolicy
from lightzero_tpu.policy.muzero import TrainBatch as JaxTrainBatch
from lightzero_tpu.policy.muzero import TrainState as JaxTrainState
from lightzero_tpu_torch.policy import MuZeroPolicy
from lightzero_tpu_torch.policy.muzero import TrainBatch, clip_by_global_norm_
from lightzero_tpu_torch.utils.params_import import flax_to_state_dict, state_dict_to_flax
from test_torch_model import perturbed_params

pytestmark = pytest.mark.unittest


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Eager ops this small gain nothing from intra-op threads, and the
    suite runs several test processes at once: their thread pools would
    fight over the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


LR = 0.003
SMALL = dict(
    model=dict(
        observation_shape=4, action_space_size=2, model_type="mlp", latent_state_dim=32,
        support_scale=10, self_supervised_learning_loss=True,
        proj_hid=64, proj_out=64, pred_hid=32, pred_out=64,
    ),
    num_simulations=5, batch_size=16, learning_rate=LR, ssl_loss_weight=2,
    optim_type="Adam", piecewise_decay_lr_scheduler=False,
)
LOG_RTOL = 1e-5
PARAM_ATOL = 1e-6
SMALL_RMS = 3e-5


@pytest.fixture(scope="module")
def jax_policy():
    """One JAX policy (one jit of its learn step) for the learn-step tests,
    with the target copied every 2 steps."""
    cfg = jax_deep_merge(JaxMuZeroPolicy.default_config(), SMALL)
    return JaxMuZeroPolicy(jax_deep_merge(cfg, dict(target_update_freq=2)))


def make_states(jax_policy, seed=0):
    """A fresh JAX TrainState from flax params perturbed from ``seed``, and
    the port's policy on the CPU holding the same params, with its state."""
    params = perturbed_params(jax_policy.model, seed)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    jax_state = JaxTrainState(
        params=params,
        target_params=jax.tree_util.tree_map(jnp.copy, params),
        opt_state=jax_policy.optimizer.init(params),
        train_iter=jnp.zeros((), jnp.int32),
    )
    port = MuZeroPolicy(dict(SMALL, target_update_freq=2), device="cpu")
    port.model.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    return jax_state, port, port.init_train_state()


def random_batch(seed, B=16, K=5, A=2, obs_dim=4):
    """A numpy-seeded batch: trailing unroll steps masked, value targets
    beyond the support (scale 10) to reach phi_transform's clamp, a
    policy-target row of zeros where the unroll left the episode."""
    rng = np.random.default_rng(seed)
    steps_left = rng.integers(0, K + 1, B)
    mask = (np.arange(K)[None] < steps_left[:, None]).astype(np.float32)
    policy = rng.dirichlet(np.ones(A), (B, K + 1)).astype(np.float32)
    policy[:, 1:] *= np.concatenate([mask, np.ones((B, 1), np.float32)], 1)[:, :K, None]
    return dict(
        obs=rng.standard_normal((B, K + 1, obs_dim)).astype(np.float32),
        actions=rng.integers(0, A, (B, K)).astype(np.int64),
        mask=mask,
        target_reward=rng.uniform(-2, 2, (B, K)).astype(np.float32),
        target_value=rng.uniform(-200, 200, (B, K + 1)).astype(np.float32),
        target_policy=policy,
        weights=rng.uniform(0.2, 1.0, B).astype(np.float32),
    )


def as_jax_batch(b):
    return JaxTrainBatch(**{k: jnp.asarray(v.astype(np.int32) if k == "actions" else v)
                            for k, v in b.items()})


def as_port_batch(b, device="cpu"):
    return TrainBatch(**{k: torch.from_numpy(v).to(device) for k, v in b.items()})


def flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def assert_params_close(port_model, jax_params, seen, lr=LR):
    """New params to PARAM_ATOL, and to 2 lr where ``seen``'s RMS of the
    gradients Adam saw is at most SMALL_RMS."""
    got = flat(state_dict_to_flax(port_model.state_dict()))
    exp = flat(jax_params)
    assert set(got) == set(exp)
    sumsq, steps = seen
    sensitive = {k: np.sqrt(v / steps) <= SMALL_RMS for k, v in sumsq.items()}
    for k in exp:
        tight = ~sensitive[k]
        np.testing.assert_allclose(got[k][tight], exp[k][tight], rtol=0, atol=PARAM_ATOL, err_msg=k)
        np.testing.assert_allclose(got[k], exp[k], rtol=0, atol=2 * lr, err_msg=k)
    n = sum(int(m.sum()) for m in sensitive.values())
    total = sum(m.size for m in sensitive.values())
    assert n <= total // 4, f"{n} of {total} elements had gradients of RMS <= {SMALL_RMS}"


def gradients_seen(jax_policy, params, batch, seen=None):
    """Adds this step's clip(g) + wd * p, squared, to ``seen`` =
    (sum of squares by parameter, steps)."""
    grads = jax.grad(lambda p: jax_policy._loss_fn(p, batch)[0])(params)
    cfg = jax_policy.cfg
    scale = min(1.0, float(cfg.grad_clip_value) / float(optax.global_norm(grads)))
    g, p = flat(grads), flat(params)
    sq = {k: (scale * g[k] + float(cfg.weight_decay) * p[k]) ** 2 for k in g}
    if seen is None:
        return sq, 1
    return {k: sq[k] + seen[0][k] for k in sq}, seen[1] + 1


def test_default_config_is_the_jax_default():
    assert MuZeroPolicy.default_config().to_dict() == JaxMuZeroPolicy.default_config().to_dict()


SCHEDULES = [
    (dict(), [0, 1, 1000]),
    (dict(piecewise_decay_lr_scheduler=True, threshold_training_steps_for_final_lr=400),
     [0, 199, 200, 201, 299, 300, 301, 5000]),
    (dict(cos_lr_scheduler=True, cos_lr_decay_steps=100), [0, 1, 50, 99, 100, 101, 1000]),
]


@pytest.mark.parametrize("override,steps", SCHEDULES, ids=["constant", "piecewise", "cosine"])
def test_lr_schedule_matches_optax(override, steps):
    jax_schedule = JaxMuZeroPolicy(
        jax_deep_merge(JaxMuZeroPolicy.default_config(), override))._lr_schedule()
    factor = MuZeroPolicy(dict(override, model=dict(latent_state_dim=8)), device="cpu")._lr_schedule()
    for c in steps:
        exp = float(jax_schedule(c)) if callable(jax_schedule) else jax_schedule
        np.testing.assert_allclose(LR * factor(c), exp, rtol=1e-6, err_msg=f"step {c}")


OPTIMIZERS = {
    "SGD": dict(optim_type="SGD"),
    "Adam": dict(optim_type="Adam"),
    "AdamW": dict(optim_type="AdamW", weight_decay=0.01),
    "AdamW_selective": dict(optim_type="AdamW", weight_decay=0.01, selective_weight_decay=True),
    "Adam_piecewise": dict(optim_type="Adam", piecewise_decay_lr_scheduler=True,
                           threshold_training_steps_for_final_lr=4),
    "SGD_cosine": dict(optim_type="SGD", cos_lr_scheduler=True, cos_lr_decay_steps=3),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_matches_optax(name):
    """5 steps on the same gradients; steps 1 and 3 exceed the clip norm."""
    override = dict(OPTIMIZERS[name], grad_clip_value=10.0)
    jax_opt = JaxMuZeroPolicy(jax_deep_merge(JaxMuZeroPolicy.default_config(), override)).optimizer
    rng = np.random.default_rng(3)
    shapes = {"w": (5, 3), "b": (5,), "scale": (3,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}

    module = torch.nn.ParameterDict({k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                                     for k, v in params.items()})
    port = MuZeroPolicy(dict(override, model=dict(latent_state_dim=8)), device="cpu")
    opt, sched = port._make_optimizer(module)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = jax_opt.init(jp)
    for step in range(5):
        scale = 8.0 if step in (1, 3) else 0.5
        grads = {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in shapes.items()}
        updates, state = jax_opt.update({k: jnp.asarray(v) for k, v in grads.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in module.items():
            p.grad = torch.from_numpy(grads[k].copy())
        norm = clip_by_global_norm_([p.grad for p in module.values()], 10.0)
        assert (float(norm) > 10.0) == (scale == 8.0)
        opt.step()
        sched.step()
        for k, p in module.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-6,
                                       err_msg=f"{name} step {step} {k}")


def test_selective_decay_spares_rank_one_tensors():
    port = MuZeroPolicy(dict(optim_type="AdamW", weight_decay=0.5, selective_weight_decay=True,
                             model=dict(latent_state_dim=8)), device="cpu")
    opt, _ = port._make_optimizer(port.model)
    decayed, spared = opt.param_groups
    assert decayed["weight_decay"] == 0.5 and spared["weight_decay"] == 0.0
    assert all(p.ndim >= 2 for p in decayed["params"]) and all(p.ndim == 1 for p in spared["params"])
    assert len(decayed["params"]) + len(spared["params"]) == len(list(port.model.parameters()))


def _check_logs(logs, jax_logs):
    assert set(logs) == set(jax_logs)
    for key, exp in jax_logs.items():
        np.testing.assert_allclose(float(logs[key]), float(exp), rtol=LOG_RTOL, atol=1e-6,
                                   err_msg=key)


def test_learn_step_matches_jax(jax_policy):
    jax_state, port, state = make_states(jax_policy)
    b = random_batch(0)
    seen = gradients_seen(jax_policy, jax_state.params, as_jax_batch(b))
    params0 = copy.deepcopy(jax_state.params)
    jax_new, jax_logs, jax_priority = jax_policy.forward_learn(jax_state, as_jax_batch(b))
    new, logs, priority = port.forward_learn(state, as_port_batch(b))
    _check_logs(logs, jax_logs)
    assert float(jax_logs["consistency_loss"]) != 0.0  # the SSL branch ran
    assert float(jax_logs["grad_norm"]) > 0
    np.testing.assert_allclose(priority.numpy(), np.asarray(jax_priority), rtol=LOG_RTOL, atol=1e-5)
    assert new.train_iter == 1 and new.model is port.model
    assert_params_close(port.model, jax_new.params, seen)
    # the target is untouched before its first copy
    assert_params_close(new.target_model, params0, seen, lr=0.0)


def test_three_learn_steps_with_a_target_copy(jax_policy):
    jax_state, port, state = make_states(jax_policy, seed=1)
    target0 = copy.deepcopy(state.target_model.state_dict())
    seen = None
    for step in range(3):
        b = random_batch(10 + step)
        seen = gradients_seen(jax_policy, jax_state.params, as_jax_batch(b), seen)
        jax_state, jax_logs, _ = jax_policy.forward_learn(jax_state, as_jax_batch(b))
        state, logs, _ = port.forward_learn(state, as_port_batch(b))
        _check_logs(logs, jax_logs)
        assert state.train_iter == int(jax_state.train_iter) == step + 1
        assert_params_close(port.model, jax_state.params, seen)
        target = state.target_model.state_dict()
        if step == 1:  # copied at train_iter 2
            assert all(torch.equal(target[k], v) for k, v in port.model.state_dict().items())
        if step == 0:
            assert all(torch.equal(target[k], v) for k, v in target0.items())
        if step == 2:  # not copied again: it still holds the step-2 params
            assert not all(torch.equal(target[k], v) for k, v in port.model.state_dict().items())
        assert_params_close(state.target_model, jax_state.target_params, seen)


def test_learn_step_refuses_harmony_and_reuse():
    # HarmonyDream is ported (tests/test_torch_harmony.py); a variant whose
    # JAX loss ignores it refuses it
    assert MuZeroPolicy(dict(model=dict(harmony_balance=True, latent_state_dim=8)),
                        device="cpu").model.harmony_policy.shape == ()
    from lightzero_tpu_torch.policy import EfficientZeroPolicy

    with pytest.raises(ValueError, match="harmony_balance"):
        EfficientZeroPolicy(dict(model=dict(harmony_balance=True)), device="cpu")
    # the multitask task embedding is ported (tests/test_torch_multitask.py)
    assert MuZeroPolicy(dict(model=dict(num_tasks=2)),
                        device="cpu").model.task_embed.weight.shape == (2, 256)
    # the reuse search is ported for two players too: a board-game policy's
    # reuse reanalyze runs, and agrees with JAX's on the same params
    # (tests/test_torch_two_player_search.py holds the search itself)
    small = dict(model=dict(latent_state_dim=8, support_scale=10), env_type="board_games",
                 num_simulations=6, reanalyze_noise=False)
    jax_policy = JaxMuZeroPolicy(jax_deep_merge(JaxMuZeroPolicy.default_config(), small))
    jax_policy.search_cfg = dataclasses.replace(jax_policy.search_cfg, tie_break="first")
    params = jax.tree_util.tree_map(jnp.asarray, perturbed_params(jax_policy.model, 2))
    port = MuZeroPolicy(small, device="cpu")
    port.model.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    port.search_cfg = dataclasses.replace(port.search_cfg, tie_break="first")
    rng = np.random.default_rng(2)
    obs = rng.standard_normal((4, 4)).astype(np.float32)
    to_play = np.array([1, 2, -1, 1], np.int32)
    true_action, reuse_value = np.array([0, 1, 1, 0]), np.array([0.3, -0.2, 0.5, 0.1], np.float32)
    got_policy, got_value = port.forward_reanalyze(
        port.model, torch.from_numpy(obs), torch.ones(4, 2, dtype=torch.bool),
        to_play=torch.from_numpy(to_play), true_action=torch.from_numpy(true_action),
        reuse_value=torch.from_numpy(reuse_value))
    exp_policy, exp_value = jax_policy.forward_reanalyze(
        params, jax.random.PRNGKey(0), jnp.asarray(obs), jnp.ones((4, 2), bool),
        jnp.asarray(to_play), true_action=jnp.asarray(true_action, jnp.int32),
        reuse_value=jnp.asarray(reuse_value))
    np.testing.assert_allclose(got_policy.numpy(), np.asarray(exp_policy), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_value.numpy(), np.asarray(exp_value), rtol=1e-5, atol=1e-5)


def test_buffer_learn_priority_sample_chain_matches_jax(jax_policy):
    """The slice's training half as a whole: the same episodes in both
    buffers, then three rounds of sample (target net bootstraps) -> learn
    step -> update_priority with each package's own priorities, compared at
    each step; the indices of the next sample must stay equal."""
    from lightzero_tpu.buffers.game_buffer import EpisodeRecord as JaxEpisodeRecord
    from lightzero_tpu.buffers.game_buffer import GameBuffer as JaxGameBuffer
    from lightzero_tpu_torch.buffers import EpisodeRecord, GameBuffer
    from test_torch_buffer import random_episodes

    jax_state, port, state = make_states(jax_policy, seed=2)
    cfg = dict(seed=7)
    jax_buf = JaxGameBuffer(jax_deep_merge(jax_policy.cfg, cfg), jax_policy)
    buf = GameBuffer(jax_deep_merge(port.cfg, cfg), port)
    episodes, priorities = random_episodes(11)
    jax_buf.push_episodes([JaxEpisodeRecord(**e) for e in episodes], priorities)
    buf.push_episodes([EpisodeRecord(**e) for e in episodes], priorities)
    seen = None
    for round_ in range(3):
        exp, exp_idx = jax_buf.sample(16, jax_state.target_params)
        got, idx = buf.sample(16, state.target_model)
        np.testing.assert_array_equal(idx, exp_idx, err_msg=f"round {round_}")
        np.testing.assert_allclose(got.target_value.numpy(), np.asarray(exp.target_value),
                                   rtol=1e-5, atol=1e-5)
        seen = gradients_seen(jax_policy, jax_state.params, exp, seen)
        jax_state, jax_logs, jax_priority = jax_policy.forward_learn(jax_state, exp)
        state, logs, priority = port.forward_learn(state, got)
        _check_logs(logs, jax_logs)
        np.testing.assert_allclose(priority.numpy(), np.asarray(jax_priority), rtol=LOG_RTOL,
                                   atol=1e-5)
        assert_params_close(port.model, jax_state.params, seen)
        jax_buf.update_priority(exp_idx, np.asarray(jax_priority))
        buf.update_priority(idx, priority.numpy())
        np.testing.assert_allclose(buf._flat_priorities, jax_buf._flat_priorities, rtol=1e-5,
                                   atol=1e-5)
