"""Port vs JAX: the multitask half of slice 19 (lightzero_tpu_torch/policy/
multitask.py, the task embedding of models/muzero.py, the task ids threaded
through policy/{muzero,unizero,sampled_unizero}.py and the curriculum stage
switch, against the same modules of lightzero_tpu), at small widths: MuZero
latent 32 with the SSL projector, UniZero and Sampled UniZero (continuous,
K=3 candidates) at embed 32, 2 layers, 4 heads; supports of 21 atoms (scale
10), 5 simulations, 3 unroll steps, 3 tasks. The flax weights are perturbed
from a numpy seed and carried across with utils/params_import.py.

- MuZero's task embedding (MLP and conv): the root latent and the heads of
  ``initial_inference`` with task ids 1e-5, the representation without one
  unconditioned; the params map both ways.
- ``task_loss_vector`` with a task absent from the batch: 1e-6, zeros there.
- ``cagrad_combine`` on agreeing, conflicting and random per-task
  gradients (float32; 25 steps of the simplex solve, the port's gradient
  analytic where JAX differentiates): each package's weights and
  combination against the solve in float64, within twice what float32
  rounding of the Gram matrix moves them (1e-5 at least); the weights on
  the simplex.
- Three learn steps of each type on the default and the CAGrad path, from
  the same params, on batches whose tasks change (a task absent, all
  present, one task alone): the logged terms 1e-5 relative (1e-6 floor;
  the mean predicted value and the priorities 1e-4, as the searches'
  values: h^-1 of a 21-atom expectation), the CAGrad weights 1e-4 (the
  float32 solve's rounding, as above) and on the simplex, the params
  under tests/test_torch_unizero_policy.py's criterion, with the Adam
  scale of the gradients the port's optimizer saw (its gradients agree
  with JAX's to rounding).
- Task views (tasks 0 and 2) search as JAX's views with injected draws:
  visit counts equal, values 1e-4; the tasks' root values differ.
- UniZero learn steps across a stage switch (2 at stage 0, then
  ``set_curriculum_stage(1)`` and 2 more): as above, and the frozen
  backbone bit-unchanged on both sides after the switch.
- The default configs equal the JAX policies'; a plain ``unizero`` with a
  task table binds no task and runs as task 0 in both packages.
- The committed ScaleZero v3 params (``data_mt/pendulum_suite_scalezero_v3_seed0/
  ckpt/params_best``, read with the JAX package's orbax reader) give flax's
  root inference for each task id at full width: the value logits, mu and
  sigma 1e-4 relative with a 1e-4 floor (two transformer layers of width
  256 summed in another order); the task views' root values differ between
  tasks.
"""
import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightzero_tpu.config.core import deep_merge as jax_deep_merge
from lightzero_tpu.models.muzero import MuZeroModel as JaxMuZeroModel
from lightzero_tpu.policy.multitask import MuZeroMTPolicy as JaxMuZeroMT
from lightzero_tpu.policy.multitask import SampledUniZeroMTPolicy as JaxSampledUniZeroMT
from lightzero_tpu.policy.multitask import UniZeroMTPolicy as JaxUniZeroMT
from lightzero_tpu.policy.multitask import attach_task_fields as jax_attach_task_fields
from lightzero_tpu.policy.multitask import cagrad_combine as jax_cagrad_combine
from lightzero_tpu.policy.multitask import task_loss_vector as jax_task_loss_vector
from lightzero_tpu.policy.muzero import TrainBatch as JaxTrainBatch
from lightzero_tpu.policy.muzero import TrainState as JaxTrainState
from lightzero_tpu.policy.sampled_muzero import SampledTrainBatch as JaxSampledTrainBatch
from lightzero_tpu.policy.unizero import UniZeroPolicy as JaxUniZeroPolicy
from lightzero_tpu_torch.models import MuZeroModel
from lightzero_tpu_torch.policy import (
    MuZeroMTPolicy,
    SampledUniZeroMTPolicy,
    UniZeroMTPolicy,
    UniZeroPolicy,
)
from lightzero_tpu_torch.policy.multitask import (
    attach_task_fields,
    cagrad_combine,
    task_loss_vector,
)
from lightzero_tpu_torch.policy.muzero import TrainBatch
from lightzero_tpu_torch.policy.sampled_muzero import SampledTrainBatch
from lightzero_tpu_torch.utils.params_import import flax_to_state_dict, state_dict_to_flax
from test_torch_learn import flat
from test_torch_unizero_policy import (
    assert_params_close,
    check_logs,
    dirichlet_from_search_key,
    perturb,
    values_close,
)
from test_torch_unizero_sampled import jax_draws

pytestmark = pytest.mark.unittest

SIMS, KS, UNROLL, LR, T = 5, 3, 3, 1e-3, 3
B = 12
TOL = 1e-5
CAGRAD_W_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def close(got, exp, tol=TOL):
    np.testing.assert_allclose(torch.as_tensor(got).detach().numpy(), np.asarray(exp),
                               rtol=tol, atol=tol)


# ------------------------------------------------------------ task embedding
@pytest.mark.parametrize("model_type", ["mlp", "conv"])
def test_muzero_task_embedding_matches_flax(model_type):
    if model_type == "mlp":
        kw, obs_shape = dict(observation_shape=4, latent_state_dim=16), (4,)
    else:
        kw = dict(observation_shape=(6, 6, 3), model_type="conv", num_channels=8,
                  downsample=False)
        obs_shape = (6, 6, 3)
    kw.update(num_tasks=3, value_support_size=21, reward_support_size=21)
    jax_model = JaxMuZeroModel(**kw)
    params = perturb(jax_model.init_params(jax.random.PRNGKey(0)), 0)
    port = MuZeroModel(**kw)
    port.load_state_dict(flax_to_state_dict(params))
    back = flat(state_dict_to_flax(port.state_dict()))
    assert back.keys() == flat(params).keys() and "params/task_embed/embedding" in back
    rng = np.random.default_rng(0)
    obs = rng.standard_normal((5,) + obs_shape).astype(np.float32)
    tid = np.array([0, 1, 2, 1, 0])
    exp = jax_model.apply(params, jnp.asarray(obs), jnp.asarray(tid),
                          method=JaxMuZeroModel.initial_inference)
    with torch.no_grad():
        got = port.initial_inference(torch.from_numpy(obs), torch.from_numpy(tid))
        plain = port.representation(torch.from_numpy(obs))
    for field in ("latent_state", "value_logits", "policy_logits"):
        close(getattr(got, field), getattr(exp, field))
    close(plain, jax_model.apply(params, jnp.asarray(obs), None,
                                 method=JaxMuZeroModel.representation))
    assert not torch.allclose(plain, got.latent_state)


# --------------------------------------------------------- loss and CAGrad
def test_task_loss_vector_matches_jax_with_an_absent_task():
    rng = np.random.default_rng(1)
    loss = rng.uniform(0, 5, 10).astype(np.float32)
    weights = rng.uniform(0.2, 1, 10).astype(np.float32)
    task_id = rng.choice([0, 2, 3], 10)
    exp_l, exp_n = jax_task_loss_vector(jnp.asarray(loss), jnp.asarray(weights),
                                        jnp.asarray(task_id), 4)
    got_l, got_n = task_loss_vector(torch.from_numpy(loss), torch.from_numpy(weights),
                                    torch.from_numpy(task_id), 4)
    close(got_l, exp_l, 1e-6)
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(exp_n))
    assert float(got_l[1]) == float(got_n[1]) == 0.0


def task_gradients(case: str, seed: int):
    """Per-task gradients (T, 5, 4) and (T, 7)."""
    rng = np.random.default_rng(seed)
    d = 27
    if case == "agreeing":
        base = rng.standard_normal(d)
        G = np.stack([base * s + 0.05 * rng.standard_normal(d) for s in (0.5, 1.0, 2.0)])
    elif case == "conflicting":
        v = rng.standard_normal(d)
        G = np.stack([v, -0.9 * v + 0.1 * rng.standard_normal(d), rng.standard_normal(d)])
    else:
        G = rng.standard_normal((T, d)) * np.array([[0.1], [1.0], [3.0]])
    G = G.astype(np.float32)
    return G[:, :20].reshape(T, 5, 4), G[:, 20:]


def cagrad_float64(G: np.ndarray, c: float = 0.4, steps: int = 25):
    """CAGrad's simplex solve in float64 (the JAX algorithm, its gradient
    written out): (w, alpha)."""
    M = G @ G.T
    ones = np.full(len(G), 1.0 / len(G))
    g0 = np.sqrt(max(ones @ M @ ones, 1e-12))
    z = np.zeros(len(G))
    for _ in range(steps):
        w = np.exp(z - z.max())
        w /= w.sum()
        q = w @ M @ w
        dw = M @ ones + c * g0 * (M @ w) / np.sqrt(max(q, 1e-12))
        z = z - 0.5 * w * (dw - w @ dw)
    w = np.exp(z - z.max())
    w /= w.sum()
    return w, ones + c * g0 / np.sqrt(max(w @ M @ w, 1e-12)) * w


def float32_spread(G: np.ndarray, seed: int = 0, draws: int = 8) -> float:
    """How far float32 rounding of the Gram matrix moves the weights: the
    largest change of the float64 solve's w under symmetric perturbations of
    M_ij by up to sqrt(d) eps32 |g_i| |g_j| (the typical error of a float32
    sum of d products)."""
    rng = np.random.default_rng(seed)
    w, _ = cagrad_float64(G)
    norms = np.linalg.norm(G, axis=1)
    bound = np.sqrt(G.shape[1]) * np.finfo(np.float32).eps * np.outer(norms, norms)
    spread = 0.0
    for _ in range(draws):
        E = rng.uniform(-1, 1, bound.shape) * bound
        Gp = np.linalg.cholesky(G @ G.T + (E + E.T) / 2 + 1e-12 * np.eye(len(G)))
        spread = max(spread, float(np.abs(cagrad_float64(Gp)[0] - w).max()))
    return spread


@pytest.mark.parametrize("case", ["agreeing", "conflicting", "random"])
def test_cagrad_combine_matches_jax(case):
    """Both packages solve in float32; each is held to the float64 solve
    within twice the change that float32 rounding of the Gram matrix causes
    (``float32_spread``: the conflicting case's M has condition ~250, and
    its w moves by up to 2.5e-3), and within 1e-5 where that change is
    smaller."""
    a, b = task_gradients(case, seed=2)
    G = np.concatenate([a.reshape(T, -1), b], 1).astype(np.float64)
    w64, alpha64 = cagrad_float64(G)
    tol_w = max(TOL, 2 * float32_spread(G))
    exp, exp_w = jax_cagrad_combine({"a": jnp.asarray(a), "b": jnp.asarray(b)})
    got, w = cagrad_combine([torch.from_numpy(a), torch.from_numpy(b)])
    combined64 = alpha64 @ G
    # an error dw in w moves the combination by lambda * dw * |g_t| summed
    tol_g = TOL + (alpha64 - 1.0 / T).max() / w64.max() * tol_w * np.abs(G).max(1).sum()
    for weights, combination in ((w.numpy(), got), (np.asarray(exp_w), (exp["a"], exp["b"]))):
        np.testing.assert_allclose(weights, w64, rtol=0, atol=tol_w)
        flat_g = np.concatenate([np.asarray(combination[0]).reshape(-1),
                                 np.asarray(combination[1])])
        np.testing.assert_allclose(flat_g, combined64, rtol=0, atol=tol_g)
    assert abs(float(w.sum()) - 1.0) < 1e-6 and bool((w >= 0).all())
    # the combination never opposes the mean gradient
    assert float(combined64 @ G.mean(0)) > 0


# -------------------------------------------------------------- learn steps
def kind_config(kind: str, **over) -> dict:
    common = dict(num_simulations=SIMS, num_unroll_steps=UNROLL, batch_size=B,
                  learning_rate=LR, task_num=T)
    if kind == "muzero":
        cfg = dict(common, model=dict(observation_shape=4, action_space_size=2,
                                      latent_state_dim=32, support_scale=10,
                                      self_supervised_learning_loss=True, proj_hid=64,
                                      proj_out=64, pred_hid=32, pred_out=64),
                   ssl_loss_weight=2.0)
    else:
        sampled = kind == "sampled_unizero"
        cfg = dict(common, weight_decay=1e-2,
                   model=dict(observation_shape=3 if sampled else 4,
                              action_space_size=1 if sampled else 2,
                              continuous_action_space=sampled, embed_dim=32, num_layers=2,
                              num_heads=4, max_tokens=16, support_scale=10))
        if sampled:
            cfg.update(num_of_sampled_actions=KS, sampled_node_prior="density")
    return jax_deep_merge(cfg, over)


CLASSES = {"muzero": (JaxMuZeroMT, MuZeroMTPolicy), "unizero": (JaxUniZeroMT, UniZeroMTPolicy),
           "sampled_unizero": (JaxSampledUniZeroMT, SampledUniZeroMTPolicy)}


def make_policies(kind: str, seed: int, **over):
    """(JAX policy, its perturbed params, the port's policy with them), both
    searching with tie_break='first'."""
    jax_cls, port_cls = CLASSES[kind]
    cfg = kind_config(kind, **over)
    jax_policy = jax_cls(jax_deep_merge(jax_cls.default_config(), cfg))
    params = perturb(jax_policy.model.init_params(jax.random.PRNGKey(seed)), seed)
    port = port_cls(cfg, device="cpu")
    port.model.load_state_dict(flax_to_state_dict(params))
    for p in (jax_policy, port):
        p.search_cfg = dataclasses.replace(p.search_cfg, tie_break="first")
    return jax_policy, jax.tree_util.tree_map(jnp.asarray, params), port


@pytest.mark.parametrize("kind", sorted(CLASSES))
def test_default_config_is_the_jax_default(kind):
    jax_cls, port_cls = CLASSES[kind]
    assert port_cls.default_config().to_dict() == jax_cls.default_config().to_dict()


def mt_batch(kind: str, seed: int, tasks):
    """(JAX batch, port batch) of B rows in blocks of ``tasks``, with
    numpy-seeded task weights."""
    rng = np.random.default_rng(seed)
    K = UNROLL
    sampled = kind == "sampled_unizero"
    steps_left = rng.integers(0, K + 1, B)
    b = dict(
        obs=rng.standard_normal((B, K + 1, 3 if sampled else 4)).astype(np.float32),
        actions=(rng.uniform(-1, 1, (B, K, 1)).astype(np.float32) if sampled
                 else rng.integers(0, 2, (B, K)).astype(np.int64)),
        mask=(np.arange(K)[None] < steps_left[:, None]).astype(np.float32),
        target_reward=rng.uniform(-2, 2, (B, K)).astype(np.float32),
        target_value=rng.uniform(-15, 15, (B, K + 1)).astype(np.float32),
        target_policy=rng.dirichlet(np.ones(KS if sampled else 2), (B, K + 1)).astype(np.float32),
        weights=rng.uniform(0.2, 1.0, B).astype(np.float32),
    )
    task_id = np.repeat(np.asarray(tasks), B // len(tasks))
    task_weights = rng.uniform(0.5, 2.0, T).astype(np.float32)
    jax_base = JaxTrainBatch(**{k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
                                for k, v in b.items()})
    port_base = TrainBatch(**{k: torch.from_numpy(v) for k, v in b.items()})
    if sampled:
        cand = rng.uniform(-0.95, 0.95, (B, K + 1, KS, 1)).astype(np.float32)
        jax_batch = JaxSampledTrainBatch(base=jax_base, sampled_actions=jnp.asarray(cand))
        port_batch = SampledTrainBatch(base=port_base, sampled_actions=torch.from_numpy(cand))
    else:
        jax_batch, port_batch = jax_base, port_base
    return (jax_attach_task_fields(jax_batch, task_id, task_weights),
            attach_task_fields(port_batch, task_id, task_weights))


def adam_scale_seen(port, before, seen=None):
    """tests/test_torch_unizero_policy.py's per-step Adam scale, from the
    gradient the port's optimizer saw this step (the clipped gradient, plus
    the L2 term under Adam; AdamW decays after Adam's scaling)."""
    l2 = float(port.cfg.weight_decay) if port.cfg.optim_type == "Adam" else 0.0
    g = {n: p.grad.detach() + l2 * before[n] for n, p in port.model.named_parameters()}
    sq = {k: v.astype(np.float64) ** 2 for k, v in flat(state_dict_to_flax(g)).items()}
    b2 = 0.999
    ema, steps, least = seen if seen is not None else ({k: 0.0 for k in sq}, 0, None)
    steps += 1
    ema = {k: b2 * ema[k] + (1 - b2) * sq[k] for k in sq}
    scale = {k: np.sqrt(ema[k] / (1 - b2 ** steps)) for k in sq}
    least = scale if least is None else {k: np.minimum(least[k], scale[k]) for k in sq}
    return (ema, steps, least), ({k: v ** 2 for k, v in least.items()}, 1)


def learn_and_compare(kind, jax_policy, jax_state, port, state, b, seen):
    """One learn step on each side on the same batch, then the checks."""
    jax_batch, port_batch = b
    before = {n: p.detach().clone() for n, p in port.model.named_parameters()}
    jax_state, jax_logs, jax_prio = jax_policy.forward_learn(jax_state, jax_batch)
    state, logs, prio = port.forward_learn(state, port_batch)
    seen, held = adam_scale_seen(port, before, seen)
    values_close(logs.pop("predicted_value"), jax_logs.pop("predicted_value"))
    if port.grad_correction == "cagrad":
        # the weights carry the float32 simplex solve's rounding, which
        # test_cagrad_combine_matches_jax bounds
        w = np.array([float(logs.pop(f"task{t}_cagrad_w")) for t in range(T)])
        exp_w = np.array([float(jax_logs.pop(f"task{t}_cagrad_w")) for t in range(T)])
        np.testing.assert_allclose(w, exp_w, rtol=0, atol=CAGRAD_W_ATOL)
        assert abs(w.sum() - 1.0) < 1e-5 and (w >= 0).all()
    check_logs(logs, jax_logs)
    values_close(prio, jax_prio)
    assert_params_close(port.model, jax_state.params, held, lr=LR)
    return jax_state, state, seen


def fresh_states(jax_policy, params, port):
    jax_state = JaxTrainState(params=params,
                              target_params=jax.tree_util.tree_map(jnp.copy, params),
                              opt_state=jax_policy.optimizer.init(params),
                              train_iter=jnp.zeros((), jnp.int32))
    return jax_state, port.init_train_state()


# the tasks of each step's batch: one absent, all present, one alone
STEP_TASKS = ([0, 2], [0, 1, 2], [1])


@pytest.mark.parametrize("grad_correction", ["none", "cagrad"])
@pytest.mark.parametrize("kind", sorted(CLASSES))
def test_learn_steps_match_jax(kind, grad_correction):
    jax_policy, params, port = make_policies(kind, seed=3, grad_correction=grad_correction)
    jax_state, state = fresh_states(jax_policy, params, port)
    seen = None
    for step, tasks in enumerate(STEP_TASKS):
        jax_state, state, seen = learn_and_compare(kind, jax_policy, jax_state, port, state,
                                                   mt_batch(kind, 40 + step, tasks), seen)
    assert state.train_iter == int(jax_state.train_iter) == len(STEP_TASKS)


def test_unizero_learn_steps_across_a_stage_switch():
    jax_policy, params, port = make_policies("unizero", seed=4,
                                             model=dict(lora_r=2, curriculum_stage_num=2))
    jax_state, state = fresh_states(jax_policy, params, port)
    seen = None
    for step in range(2):
        jax_state, state, seen = learn_and_compare("unizero", jax_policy, jax_state, port, state,
                                                   mt_batch("unizero", 50 + step, [0, 1, 2]),
                                                   seen)
    jax_policy.set_curriculum_stage(1)
    jax_state = jax_state._replace(opt_state=jax_policy.optimizer.init(jax_state.params))
    state = port.set_curriculum_stage(1, state)
    assert port.model.tcfg.curriculum_stage == state.target_model.tcfg.curriculum_stage == 1
    frozen = {n: p.detach().clone() for n, p in port.model.named_parameters()
              if n.startswith("transformer.") and "lora_" not in n and "_scale" not in n}
    jax_frozen = flat(jax_state.params)
    assert any(n.endswith("base.weight") for n in frozen)
    assert "transformer.task_embed.weight" in frozen
    seen = None
    for step in range(2):
        jax_state, state, seen = learn_and_compare("unizero", jax_policy, jax_state, port, state,
                                                   mt_batch("unizero", 60 + step, [0, 2]), seen)
    after = dict(port.model.named_parameters())
    assert all(torch.equal(after[n], v) for n, v in frozen.items())
    jax_after = flat(jax_state.params)
    moved = [k for k in jax_after if not np.array_equal(jax_after[k], jax_frozen[k])]
    assert not any(k.startswith("params/_wm/") and "lora_" not in k and "_scale" not in k
                   for k in moved)
    assert any("lora_A_1" in k for k in moved)


# --------------------------------------------------------------- task views
@pytest.mark.parametrize("kind", sorted(CLASSES))
def test_task_views_search_as_jax(kind):
    jax_policy, params, port = make_policies(kind, seed=5)
    rng = np.random.default_rng(5)
    Bs = 3
    sampled = kind == "sampled_unizero"
    A = KS if sampled else 2
    obs = rng.standard_normal((Bs, 3 if sampled else 4)).astype(np.float32)
    legal = np.ones((Bs, 1 if sampled else 2), bool)
    to_play = np.full(Bs, -1, np.int32)
    args = (jnp.asarray(obs), jnp.asarray(legal), jnp.asarray(to_play), 1.0, 0.0)
    port_args = (torch.from_numpy(obs), torch.from_numpy(legal), torch.from_numpy(to_play), 1.0,
                 0.0)
    values = []
    for task in (0, 2):
        jv, pv = jax_policy.task_view(task), port.task_view(task)
        assert pv.model is port.model and pv._collect_task_id == task
        key = jax.random.PRNGKey(20 + task)
        if kind == "muzero":
            noise = dirichlet_from_search_key(jax.random.split(key, 5)[1], Bs, A)
            exp = jv._forward_collect(params, key, *args, deterministic=False)
            got = pv._forward_collect(*port_args, deterministic=False, noise=noise)
        elif kind == "unizero":
            noise = dirichlet_from_search_key(jax.random.split(key, 5)[1], Bs, A)
            exp, _ = jv._forward_collect_stateful(params, key, *args, jv.init_collect_state(Bs),
                                                  deterministic=False)
            got, _ = pv._forward_collect_stateful(*port_args, pv.init_collect_state(Bs),
                                                  deterministic=False, noise=noise)
        else:
            root_draws, sim_draws, noise = jax_draws(key, Bs, False)
            exp, _ = jv._forward_collect_stateful(params, key, *args, jv.init_collect_state(Bs),
                                                  deterministic=False)
            got, _ = pv._forward_collect_stateful(*port_args, pv.init_collect_state(Bs),
                                                  deterministic=False, noise=noise,
                                                  root_draws=root_draws, sim_draws=sim_draws)
        np.testing.assert_array_equal(got["visit_counts"].numpy(), np.asarray(exp["visit_counts"]))
        for k in ("searched_value", "predicted_value"):
            values_close(got[k], exp[k])
        values.append(got["predicted_value"])
    assert not torch.allclose(values[0], values[1])  # the task conditions the search


# ------------------------------------------------ plain unizero with a table
def test_plain_unizero_with_a_task_table_runs_as_task_0():
    cfg = kind_config("unizero", model=dict(num_tasks=2))
    jax_policy = JaxUniZeroPolicy(jax_deep_merge(JaxUniZeroPolicy.default_config(), cfg))
    params = perturb(jax_policy.model.init_params(jax.random.PRNGKey(6)), 6)
    port = UniZeroPolicy(cfg, device="cpu")
    port.model.load_state_dict(flax_to_state_dict(params))
    assert not hasattr(port, "task_view") and not hasattr(jax_policy, "task_view")
    assert port._task_ids(3) is None and jax_policy._task_ids(3) is None
    rng = np.random.default_rng(6)
    obs = rng.standard_normal((3, UNROLL + 1, 4)).astype(np.float32)
    actions = rng.integers(0, 2, (3, UNROLL))

    def jax_out(tid):
        return jax_policy.model.apply(
            params, jnp.asarray(obs), jnp.asarray(actions, jnp.int32),
            None if tid is None else jnp.full((3,), tid, jnp.int32),
            method=type(jax_policy.model).train_forward)["value_logits"]

    with torch.no_grad():
        def port_out(tid):
            return port.model.train_forward(
                torch.from_numpy(obs), torch.from_numpy(actions),
                None if tid is None else torch.full((3,), tid))["value_logits"]

        close(port_out(None), jax_out(None))
        assert torch.equal(port_out(None), port_out(0))
        assert not torch.allclose(port_out(None), port_out(1))
    np.testing.assert_array_equal(np.asarray(jax_out(None)), np.asarray(jax_out(0)))


# ------------------------------------------------ committed ScaleZero params
SCALEZERO_RUN = pathlib.Path(__file__).resolve().parent.parent / (
    "data_mt/pendulum_suite_scalezero_v3_seed0")


def test_committed_scalezero_params_give_flaxs_root_inference_per_task():
    from lightzero_tpu.config import Config as JaxConfig
    from lightzero_tpu.models.unizero import UniZeroModel as JaxUniZeroModel
    from lightzero_tpu.utils.checkpoint import load_checkpoint
    from lightzero_tpu_torch.config import Config

    total = json.loads((SCALEZERO_RUN / "total_config.json").read_text())
    params = load_checkpoint(str(SCALEZERO_RUN / "ckpt" / "params_best"))["params"]
    jax_policy = JaxSampledUniZeroMT(JaxConfig(total["policy"]))
    port = SampledUniZeroMTPolicy(Config(total["policy"]), device="cpu")
    port.model.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    assert port.model.embed_dim == 256 and port.task_num == 3 and port.K == 20
    rng = np.random.default_rng(7)
    theta, theta_dot = rng.uniform(-np.pi, np.pi, 4), rng.uniform(-8, 8, 4)
    obs = np.stack([np.cos(theta), np.sin(theta), theta_dot], 1).astype(np.float32)
    roots = []
    for task in range(3):
        tid = np.full(4, task)
        obs_e = jax_policy.model.apply(params, jnp.asarray(obs),
                                       method=JaxUniZeroModel.encode_obs)
        exp, _ = jax_policy.model.apply(params, jax_policy._fresh_cache(4), obs_e,
                                        jnp.asarray(tid), method=JaxUniZeroModel.infer_obs_step)
        with torch.no_grad():
            got, _ = port.model.infer_obs_step(
                port._fresh_cache(4), port.model.encode_obs(torch.from_numpy(obs)),
                torch.from_numpy(tid))
        for key in ("value_logits", "mu", "sigma"):
            np.testing.assert_allclose(got[key].numpy(), np.asarray(exp[key]), rtol=1e-4,
                                       atol=1e-4, err_msg=f"task {task} {key}")
        view = port.task_view(task)
        root, _ = view._root(port.model, torch.from_numpy(obs), port._fresh_cache(4))
        roots.append(root.value)
    assert not torch.allclose(roots[0], roots[2])  # the task conditions the root
