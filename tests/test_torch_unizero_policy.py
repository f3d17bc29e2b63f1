"""Port vs JAX: the UniZero policy (lightzero_tpu_torch/policy/unizero.py and
UniZero's context history in buffers/game_buffer.py against
lightzero_tpu/policy/unizero.py and lightzero_tpu/buffers/game_buffer.py),
at small widths: embed 32, 2 layers, 4 heads, supports of 21 atoms (scale
10), 5 simulations, 3 unroll steps, vector observations (CartPole's 4), A=2.
The flax weights are perturbed from a numpy seed and carried across with
utils/params_import.py.

- The default config equals the JAX policy's.
- ``_forward_collect_stateful`` over 6 steps from a per-env KV cache, one
  env reset after step 2, root noise rebuilt from JAX's key, tie_break
  'first', temperature 0.01 (5 visits over 2 actions: the majority is taken
  with probability 1 - 1e-17, so both sides act alike): visit counts and
  actions equal, searched and predicted values 1e-4 relative with a 1e-4
  floor, and the contexts (KV caches) to 1e-5, positions exactly.
- Learn steps against the JAX learn step (jitted) from the same params, with
  drift correction of depth 2, the ``group_kl`` latent loss, the adaptive
  entropy with its own Adam, accumulation over 2 micro-batches and the
  selective decay: 4 steps with Encoder-Clip and Head-Clip acting
  (thresholds below the norms they meet); 4 steps without the clips, the
  third on a batch with a NaN observation; and a NaN batch with the clips
  on, on which the JAX step writes NaN into the encoder (min(1, threshold /
  NaN), ROADMAP queue 3) and the port's leaves its params alone. The logged
  terms 1e-5 relative (1e-6 absolute floor); the params under the criterion of tests/test_torch_learn.py with
  the per-step Adam scale of tests/test_torch_efficientzero.py (an element
  whose Adam scale was ever at most 3e-5 is held to 2 lr; the gradient Adam
  sees is the clipped gradient alone, AdamW decaying after Adam's scaling).
  A NaN step logs ``nonfinite_loss`` 1 on both sides and leaves the port's
  params and optimizer state bit for bit as they were, as the JAX step
  (clips off) leaves its own; the step after it agrees with JAX again.
- The context reanalyze: ``forward_reanalyze`` with the prefill of a full
  history against JAX's with the same Dirichlet noise (from its key):
  normalised visits equal, root values 1e-4; the buffer's history arrays
  (``obs_hist``, ``act_hist``, ``hist_len``) equal the JAX buffer's on the
  native and the Python path, and the reanalyzed targets equal JAX's at
  every position with a full history (JAX's shorter ones are the prefill
  fault of ROADMAP queue 3: NaN priors, a one-hot policy on action 0); the
  bootstrap value targets 1e-4 relative with a 1e-4 floor, as the searches'
  values (h^-1 of a 21-atom expectation after two transformer layers).
- The curriculum optimizer: at stage 1 only adapter 1, the base scales, the
  encoder and the heads move.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lightzero_tpu.buffers.game_buffer import EpisodeRecord as JaxEpisodeRecord
from lightzero_tpu.buffers.game_buffer import GameBuffer as JaxGameBuffer
from lightzero_tpu.config.core import deep_merge as jax_deep_merge
from lightzero_tpu.policy.muzero import TrainBatch as JaxTrainBatch
from lightzero_tpu.policy.muzero import TrainState as JaxTrainState
from lightzero_tpu.policy.unizero import UniZeroPolicy as JaxUniZeroPolicy
from lightzero_tpu_torch.buffers import EpisodeRecord, GameBuffer
from lightzero_tpu_torch.policy import UniZeroPolicy
from lightzero_tpu_torch.policy.muzero import TrainBatch
from lightzero_tpu_torch.utils.params_import import flax_to_state_dict
from test_torch_buffer import random_episodes
from test_torch_learn import PARAM_ATOL, SMALL_RMS, flat

pytestmark = pytest.mark.unittest

SIMS = 5
UNROLL = 3
LR = 1e-3
VALUE_RTOL = VALUE_ATOL = 1e-4
LOG_RTOL = 1e-5
SMALL = dict(
    model=dict(observation_shape=4, action_space_size=2, embed_dim=32, num_layers=2,
               num_heads=4, max_tokens=16, support_scale=10),
    num_simulations=SIMS, num_unroll_steps=UNROLL, batch_size=8, learning_rate=LR,
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def perturb(params, seed: int, scale: float = 0.1):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + (rng.standard_normal(np.shape(x)) * scale).astype(np.float32),
        params)


def make_policies(seed=0, **override):
    """(JAX policy, its perturbed params, the port's policy on the CPU with
    them), both searching with tie_break='first'."""
    cfg = jax_deep_merge(SMALL, override)
    jax_policy = JaxUniZeroPolicy(jax_deep_merge(JaxUniZeroPolicy.default_config(), cfg))
    params = perturb(jax_policy.model.init_params(jax.random.PRNGKey(seed)), seed)
    port = UniZeroPolicy(cfg, device="cpu")
    port.model.load_state_dict(flax_to_state_dict(params))
    for p in (jax_policy, port):
        p.search_cfg = dataclasses.replace(p.search_cfg, tie_break="first")
    return jax_policy, jax.tree_util.tree_map(jnp.asarray, params), port


def values_close(got, exp):
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=VALUE_RTOL, atol=VALUE_ATOL)


def test_default_config_is_the_jax_default():
    assert UniZeroPolicy.default_config().to_dict() == JaxUniZeroPolicy.default_config().to_dict()


def dirichlet_from_search_key(s_rng, B, A):
    _, prep_rng = jax.random.split(s_rng)
    g = jax.random.gamma(prep_rng, 0.3, (B, A), jnp.float32)
    return torch.from_numpy(np.array(g / jnp.sum(g, axis=-1, keepdims=True)))


def test_stateful_collect_searches_as_jax():
    jax_policy, params, port = make_policies(seed=1)
    B, A, steps = 3, 2, 6
    collect = jax.jit(jax_policy._forward_collect_stateful, static_argnames="deterministic")
    rng = np.random.default_rng(1)
    obs = rng.standard_normal((steps, B, 4)).astype(np.float32)
    legal = np.ones((B, A), bool)
    to_play = np.full(B, -1, np.int32)
    jstate, state = jax_policy.init_collect_state(B), port.init_collect_state(B)
    for t in range(steps):
        key = jax.random.PRNGKey(100 + t)
        _, s_rng, _, _, _ = jax.random.split(key, 5)
        noise = dirichlet_from_search_key(s_rng, B, A)
        exp, jstate = collect(params, key, jnp.asarray(obs[t]), jnp.asarray(legal),
                              jnp.asarray(to_play), 0.01, 0.0, jstate, deterministic=False)
        got, state = port._forward_collect_stateful(
            torch.from_numpy(obs[t]), torch.from_numpy(legal), torch.from_numpy(to_play),
            0.01, 0.0, state, deterministic=False, noise=noise)
        np.testing.assert_array_equal(got["visit_counts"].numpy(), np.asarray(exp["visit_counts"]))
        np.testing.assert_array_equal(got["action"].numpy(), np.asarray(exp["action"]))
        values_close(got["searched_value"], exp["searched_value"])
        values_close(got["predicted_value"], exp["predicted_value"])
        if t == 2:
            done = np.array([False, True, False])
            jstate = jax_policy.reset_collect_state(jstate, jnp.asarray(done))
            state = port.reset_collect_state(state, torch.from_numpy(done))
        np.testing.assert_allclose(state.k.numpy(), np.asarray(jstate.k), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(state.pos.numpy(), np.asarray(jstate.pos))
        np.testing.assert_array_equal(state.next_pos.numpy(), np.asarray(jstate.next_pos))
    assert int(state.next_pos[0]) == 2 * steps and int(state.next_pos[1]) == 2 * (steps - 3)


# --------------------------------------------------------------------- learn
LEARN = dict(
    drift_correction_weight=1.0, drift_correction_depth=2, predict_latent_loss_type="group_kl",
    use_adaptive_entropy_weight=True, accumulation_steps=2, target_update_freq=3,
    use_encoder_clip_annealing=True, encoder_clip_start=0.8, encoder_clip_end=0.5,
    encoder_clip_anneal_steps=4, use_head_clip=True, head_clip_start=0.1, head_clip_end=0.05,
    head_clip_anneal_steps=4, head_clip_anneal_type="linear", weight_decay=1e-2,
)


def random_batch(seed, B=8, K=UNROLL, A=2, nan=False):
    rng = np.random.default_rng(seed)
    steps_left = rng.integers(0, K + 1, B)
    mask = (np.arange(K)[None] < steps_left[:, None]).astype(np.float32)
    obs = rng.standard_normal((B, K + 1, 4)).astype(np.float32)
    if nan:
        obs[0, 1, 2] = np.nan
    return dict(
        obs=obs,
        actions=rng.integers(0, A, (B, K)).astype(np.int64),
        mask=mask,
        target_reward=rng.uniform(-2, 2, (B, K)).astype(np.float32),
        target_value=rng.uniform(-15, 15, (B, K + 1)).astype(np.float32),
        target_policy=rng.dirichlet(np.ones(A), (B, K + 1)).astype(np.float32),
        weights=rng.uniform(0.2, 1.0, B).astype(np.float32),
    )


def as_jax(b):
    return JaxTrainBatch(**{k: jnp.asarray(v.astype(np.int32) if k == "actions" else v)
                            for k, v in b.items()})


def as_port(b):
    return TrainBatch(**{k: torch.from_numpy(v) for k, v in b.items()})


def adam_scale_seen(jax_policy, params, batch, it, seen=None, grad_fn=None):
    """tests/test_torch_efficientzero.py's per-step Adam scale: adds one step
    to ``seen`` = (second-moment EMA of the gradient Adam sees, steps, least
    sqrt(v_t) so far) and returns it with the least scale as
    ``assert_params_close`` takes it, (scale squared, 1). Adam sees the
    clipped gradient alone: AdamW decays after Adam's scaling. ``grad_fn(params,
    batch, it)`` (a jitted gradient, say) replaces the eager ``jax.grad``."""
    if grad_fn is None:
        grads = jax.grad(lambda p: jax_policy._loss_fn(p, batch, jnp.asarray(it))[0])(params)
    else:
        grads = grad_fn(params, batch, jnp.asarray(it))
    clip = min(1.0, float(jax_policy.cfg.grad_clip_value) / float(optax.global_norm(grads)))
    sq = {k: (clip * g) ** 2 for k, g in flat(grads).items()}
    b2 = 0.999
    ema, steps, least = seen if seen is not None else ({k: 0.0 for k in sq}, 0, None)
    steps += 1
    ema = {k: b2 * ema[k] + (1 - b2) * sq[k] for k in sq}
    scale = {k: np.sqrt(ema[k] / (1 - b2 ** steps)) for k in sq}
    least = scale if least is None else {k: np.minimum(least[k], scale[k]) for k in sq}
    return (ema, steps, least), ({k: v ** 2 for k, v in least.items()}, 1)


def assert_params_close(port_model, jax_params, seen, lr=LR):
    """tests/test_torch_learn.py's criterion (PARAM_ATOL where the RMS of
    the gradients Adam saw exceeds SMALL_RMS, 2 lr elsewhere, and those
    under a quarter of the elements), with the 0-d ``log_alpha`` too."""
    from lightzero_tpu_torch.utils.params_import import state_dict_to_flax

    got = {k: np.atleast_1d(v) for k, v in flat(state_dict_to_flax(port_model.state_dict())).items()}
    exp = {k: np.atleast_1d(v) for k, v in flat(jax_params).items()}
    assert set(got) == set(exp)
    sumsq, steps = seen
    loose = {k: np.atleast_1d(np.sqrt(v / steps) <= SMALL_RMS) for k, v in sumsq.items()}
    for k in exp:
        tight = ~loose[k]
        np.testing.assert_allclose(got[k][tight], exp[k][tight], rtol=0, atol=PARAM_ATOL, err_msg=k)
        np.testing.assert_allclose(got[k], exp[k], rtol=0, atol=2 * lr, err_msg=k)
    n = sum(int(m.sum()) for m in loose.values())
    total = sum(m.size for m in loose.values())
    assert n <= total // 4, f"{n} of {total} elements had gradients of RMS <= {SMALL_RMS}"


def check_logs(logs, jax_logs):
    assert set(logs) == set(jax_logs)
    for key, exp in jax_logs.items():
        np.testing.assert_allclose(float(logs[key]), float(exp), rtol=LOG_RTOL, atol=1e-6,
                                   err_msg=key)


def opt_snapshot(optimizer):
    return {id(p): {k: v.clone() for k, v in s.items()} for p, s in optimizer.state.items()}


# (clips on, the steps whose batch holds a NaN observation)
LEARN_CASES = {"clips": (True, ()), "nonfinite_guard": (False, (2,)),
               "jax_clip_fault": (True, (1,))}


@pytest.mark.parametrize("case", sorted(LEARN_CASES))
def test_learn_steps_match_jax(case):
    """'clips': 4 steps with every term and both clips acting.
    'nonfinite_guard': a NaN batch at step 2 (clips off) leaves the params
    and the optimizer state of both sides untouched, and the next step
    agrees again. 'jax_clip_fault': a NaN batch with the clips on, where the
    JAX step writes NaN into the encoder (ROADMAP queue 3) and the port's
    leaves everything untouched."""
    clips, nan_steps = LEARN_CASES[case]
    jax_policy, params, port = make_policies(
        seed=2, **dict(LEARN, use_encoder_clip_annealing=clips, use_head_clip=clips))
    jax_state = JaxTrainState(params=params,
                              target_params=jax.tree_util.tree_map(jnp.copy, params),
                              opt_state=jax_policy.optimizer.init(params),
                              train_iter=jnp.zeros((), jnp.int32))
    state = port.init_train_state()
    assert len(state.optimizer.param_groups[2]["params"]) == 1  # log_alpha's Adam
    seen, clip_scales = None, []
    for step in range(4 if case != "jax_clip_fault" else 2):
        nan = step in nan_steps
        b = random_batch(20 + step, nan=nan)
        if not nan:
            seen, held = adam_scale_seen(jax_policy, jax_state.params, as_jax(b), step, seen)
        before = {k: v.clone() for k, v in port.model.state_dict().items()}
        opt_before = opt_snapshot(state.optimizer)
        jax_before = jax.tree_util.tree_map(np.array, (jax_state.params, jax_state.opt_state))
        jax_state, jax_logs, jax_prio = jax_policy.forward_learn(jax_state, as_jax(b))
        state, logs, prio = port.forward_learn(state, as_port(b))
        assert float(logs["nonfinite_loss"]) == float(jax_logs["nonfinite_loss"]) == float(nan)
        assert state.train_iter == int(jax_state.train_iter) == step + 1
        if nan:
            after = port.model.state_dict()
            assert all(torch.equal(after[k], v) for k, v in before.items())
            opt_after = opt_snapshot(state.optimizer)
            assert opt_after.keys() == opt_before.keys()
            assert all(torch.equal(opt_after[i][k], v) for i, st in opt_before.items()
                       for k, v in st.items())
            jax_after = flat(jax_state.params)
            if case == "jax_clip_fault":
                assert np.isnan(jax_after["params/_enc/Dense_0/kernel"]).all()
                continue
            for x, e in zip(jax.tree_util.tree_leaves((jax_state.params, jax_state.opt_state)),
                            jax.tree_util.tree_leaves(jax_before)):
                np.testing.assert_array_equal(np.asarray(x), e)
            continue
        check_logs(logs, jax_logs)
        if clips:
            clip_scales.append(min(float(jax_logs["encoder_clip_scale"]),
                                   *(float(jax_logs[f"head_clip_scale/_{h}_head"])
                                     for h in ("policy", "value", "reward"))))
        assert float(jax_logs["dc_reward_loss"]) > 0 and float(jax_logs["alpha_loss"]) != 0
        np.testing.assert_allclose(prio.numpy(), np.asarray(jax_prio), rtol=LOG_RTOL, atol=1e-5)
        assert_params_close(port.model, jax_state.params, held, lr=LR)
        assert_params_close(state.target_model, jax_state.target_params, held, lr=LR)
    if clips:
        assert min(clip_scales) < 1.0  # the clips acted


# ---------------------------------------------------------------- reanalyze
H = 4


def test_context_reanalyze_matches_jax_with_a_full_history():
    jax_policy, params, port = make_policies(seed=3)
    B, A = 4, 2
    rng = np.random.default_rng(3)
    obs_hist = rng.standard_normal((B, H + 1, 4)).astype(np.float32)
    act_hist = rng.integers(0, A, (B, H))
    hist_len = np.array([H, H, H, 1])
    legal = np.ones((B, A), bool)
    key = jax.random.PRNGKey(7)
    exp_p, exp_v = jax_policy.forward_reanalyze(
        params, key, jnp.asarray(obs_hist[:, -1]), jnp.asarray(legal), None,
        obs_hist=jnp.asarray(obs_hist), act_hist=jnp.asarray(act_hist, jnp.int32),
        hist_len=jnp.asarray(hist_len, jnp.int32))
    got_p, got_v = port.forward_reanalyze(
        port.model, torch.from_numpy(obs_hist[:, -1]), torch.from_numpy(legal),
        noise=dirichlet_from_search_key(key, B, A), obs_hist=torch.from_numpy(obs_hist),
        act_hist=torch.from_numpy(act_hist), hist_len=torch.from_numpy(hist_len))
    full = hist_len == H
    np.testing.assert_array_equal(got_p.numpy()[full], np.asarray(exp_p)[full])
    values_close(got_v[full], np.asarray(exp_v)[full])
    # the short row: JAX's root prior is NaN, so every simulation takes
    # action 0; here it is a search of the short context
    np.testing.assert_array_equal(np.asarray(exp_p)[~full], [[1.0, 0.0]])
    assert torch.isfinite(got_v).all() and torch.allclose(got_p.sum(-1), torch.ones(B))
    assert float(got_p[~torch.from_numpy(full)][0, 1]) > 0


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "python"])
def test_buffer_threads_the_jax_history_into_reanalyze(use_native):
    jax_policy, params, port = make_policies(seed=4, reanalyze_noise=False)
    cfg = dict(SMALL, seed=3, batch_size=8, reanalyze_ratio=0.5, use_native_replay=use_native)
    jax_buf = JaxGameBuffer(jax_deep_merge(jax_policy.cfg, cfg), jax_policy)
    buf = GameBuffer(jax_deep_merge(port.cfg, cfg), port)
    episodes, priorities = random_episodes(6)
    jax_buf.push_episodes([JaxEpisodeRecord(**e) for e in episodes], priorities)
    buf.push_episodes([EpisodeRecord(**e) for e in episodes], priorities)
    seen = {}

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            seen[name] = {k: np.asarray(kwargs[k]) for k in ("obs_hist", "act_hist", "hist_len")}
            return fn(*args, **kwargs)
        return wrapped

    jax_policy.forward_reanalyze = spy("jax", jax_policy.forward_reanalyze)
    port.forward_reanalyze = spy("port", port.forward_reanalyze)
    exp, exp_idx = jax_buf.sample(8, params)
    got, idx = buf.sample(8, port.model)
    np.testing.assert_array_equal(idx, exp_idx)
    for k in ("obs_hist", "act_hist", "hist_len"):
        np.testing.assert_array_equal(seen["port"][k], seen["jax"][k], err_msg=k)
    hl = seen["jax"]["hist_len"].reshape(4, UNROLL + 1)
    assert (hl == H).any() and (hl < H).any()
    n_re = 4
    full = hl == H
    np.testing.assert_allclose(got.target_policy.numpy()[:n_re][full],
                               np.asarray(exp.target_policy)[:n_re][full], atol=1e-6)
    np.testing.assert_allclose(got.target_policy.numpy()[n_re:],
                               np.asarray(exp.target_policy)[n_re:], atol=1e-6)
    for f in ("obs", "actions", "mask", "target_reward", "weights"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(exp, f)),
                                   atol=1e-6, err_msg=f)
    values_close(got.target_value, exp.target_value)


def test_curriculum_stage_trains_only_its_parameters():
    _, _, port = make_policies(seed=5, model=dict(lora_r=2, curriculum_stage_num=3,
                                                  curriculum_stage=1))
    for name, p in port.model.named_parameters():
        if "lora_B_" in name:  # zero-init B would keep adapter A's gradient at 0
            p.data.normal_(0.0, 0.1)
    state = port.init_train_state()
    before = copy.deepcopy(port.model.state_dict())
    state, logs, _ = port.forward_learn(state, as_port(random_batch(30)))
    moved = {k for k, v in port.model.state_dict().items() if not torch.equal(v, before[k])}
    assert any("lora_A_1" in k for k in moved) and any("base_scale" in k for k in moved)
    assert not any("lora_A_2" in k or "lora_B_2" in k or "adapter_scale_1" in k for k in moved)
    assert not any(k.startswith("transformer.") and k.endswith("base.weight") for k in moved)
    assert any(k.startswith("encoder.") for k in moved)
    assert any(k.startswith("value_head.") for k in moved)
