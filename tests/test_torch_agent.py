"""Port vs JAX: the Agent API (lightzero_tpu_torch/agent/ against
lightzero_tpu/agent/) and the evaluator's replay capture
(lightzero_tpu_torch/workers/evaluator.py, ``save_replay_path``).

- ``BUNDLED_CONFIGS`` and ``_LEGACY_CONFIGS`` equal JAX's key for key, and
  every snapshot builds into a port policy on the CPU (the AlphaZero types
  with their env), but the Stochastic MuZero one: its conv model under a
  policy that flattens observations fails at JAX's first search, and the
  port refuses it (ROADMAP queue 3).
- A tiny CartPole ``MuZeroAgent`` trains on the CPU, deploys with replay
  (one ``episode_<i>.npz`` per ended episode, ``obs``/``actions``/
  ``rewards`` of one length, ``episode_return`` their sum), and evaluates
  again from its ``ckpt_final.pt``.
- The replay files' keys, dtypes and shapes equal those the JAX
  evaluator writes for the same env.
- Where the JAX Agent fails, the port refuses with a ValueError that quotes
  it (ROADMAP queue 3): an AlphaZero agent's batch_evaluate, and replays
  on a host env.
"""
import copy
import glob
import os

import jax
import numpy as np
import pytest
import torch

from lightzero_tpu.agent import AlphaZeroAgent as JaxAlphaZeroAgent
from lightzero_tpu.agent import BUNDLED_CONFIGS as JAX_BUNDLED
from lightzero_tpu.agent import MuZeroAgent as JaxMuZeroAgent
from lightzero_tpu.agent.agent import _LEGACY_CONFIGS as JAX_LEGACY
from lightzero_tpu.config import Config as JaxConfig
from lightzero_tpu.envs.cartpole import CartPoleEnv as JaxCartPoleEnv
from lightzero_tpu.policy.muzero import MuZeroPolicy as JaxMuZeroPolicy
from lightzero_tpu.workers import Evaluator as JaxEvaluator
from lightzero_tpu_torch import agent
from lightzero_tpu_torch.agent.agent import _LEGACY_CONFIGS
from lightzero_tpu_torch.config import Config, compile_config
from lightzero_tpu_torch.entry.train_muzero import POLICIES, create_env
from lightzero_tpu_torch.envs import CartPoleEnv
from lightzero_tpu_torch.policy import MuZeroPolicy
from lightzero_tpu_torch.workers import Evaluator

pytestmark = pytest.mark.unittest


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def as_dicts(table):
    return {algo: {env: cfg.to_dict() for env, cfg in envs.items()}
            for algo, envs in table.items()}


def test_bundled_and_legacy_configs_equal_jax():
    assert as_dicts(agent.BUNDLED_CONFIGS) == as_dicts(JAX_BUNDLED)
    assert as_dicts(_LEGACY_CONFIGS) == as_dicts(JAX_LEGACY)
    assert sum(len(v) for v in agent.BUNDLED_CONFIGS.values()) == 18


SNAPSHOTS = sorted((algo, env) for algo, envs in JAX_BUNDLED.items() for env in envs)


@pytest.mark.parametrize("algo,env_id", SNAPSHOTS, ids=[f"{a}-{e}" for a, e in SNAPSHOTS])
def test_every_snapshot_builds_a_port_policy(algo, env_id):
    cfg = copy.deepcopy(agent.BUNDLED_CONFIGS[algo][env_id])
    ptype = cfg.policy.get("type", "muzero")
    env = create_env(cfg.env)
    assert env is not None  # every snapshot runs on a tensor env
    if "alphazero" in ptype:
        import lightzero_tpu_torch.policy as policies

        cls = {"alphazero": policies.AlphaZeroPolicy,
               "sampled_alphazero": policies.SampledAlphaZeroPolicy}[ptype]
        policy = cls(cfg.policy, env, device="cpu")
    else:
        pcls = POLICIES[ptype]
        compiled = compile_config(cfg, pcls.default_config(), 0, save_cfg=False)
        if ptype == "stochastic_muzero":
            # a conv model under a policy that flattens its observations:
            # JAX fails at its first search, the port refuses it
            with pytest.raises(ValueError, match="flattens observations"):
                pcls(compiled.policy, device="cpu")
            return
        policy = pcls(compiled.policy, device="cpu")
    assert sum(p.numel() for p in policy.model.parameters()) > 0


def test_the_bundled_stochastic_snapshot_fails_in_jax():
    import flax
    import jax.numpy as jnp

    from lightzero_tpu.config import compile_config as jax_compile_config
    from lightzero_tpu.envs.game_2048 import Game2048Env
    from lightzero_tpu.policy.stochastic_muzero import StochasticMuZeroPolicy

    cfg = copy.deepcopy(JAX_BUNDLED["stochastic_muzero"]["game_2048"])
    policy = StochasticMuZeroPolicy(jax_compile_config(
        cfg, StochasticMuZeroPolicy.default_config(), 0, save_cfg=False).policy)
    params = jax.jit(policy.init_train_state)(jax.random.PRNGKey(0)).params
    _, obs = Game2048Env().reset(jax.random.PRNGKey(0))
    with pytest.raises(flax.errors.ScopeParamShapeError):
        policy._forward_collect(params, jax.random.PRNGKey(1), obs[None], jnp.ones((1, 4), bool),
                                jnp.full((1,), -1), 1.0, 0.0)


def tiny_cartpole(exp_dir, **env):
    return Config(dict(
        exp_name=str(exp_dir),
        env=dict(dict(env_id="CartPole-v0", stop_value=1e9, collector_env_num=2,
                      evaluator_env_num=2, n_evaluator_episode=2, max_episode_steps=12), **env),
        policy=dict(model=dict(observation_shape=4, action_space_size=2, latent_state_dim=8,
                               proj_hid=16, proj_out=16, pred_hid=8, pred_out=16),
                    num_simulations=3, batch_size=8, update_per_collect=2, n_episode=2,
                    eval_freq=1000),
    ))


def check_replays(paths, returns=None):
    for i, path in enumerate(paths):
        rec = np.load(path)
        assert sorted(rec.files) == ["actions", "episode_return", "obs", "rewards"]
        T = len(rec["rewards"])
        assert T > 0 and rec["obs"].shape[0] == T == rec["actions"].shape[0]
        np.testing.assert_allclose(float(rec["episode_return"]), rec["rewards"].sum(), rtol=1e-6)
        if returns is not None:
            assert float(rec["episode_return"]) == returns[i]


def test_agent_trains_deploys_with_replay_and_reloads(tmp_path):
    cfg = tiny_cartpole(tmp_path / "exp")
    a = agent.MuZeroAgent(cfg=cfg, device="cpu")
    stats = a.train(max_train_iter=2)
    assert stats["train_iter"] == 2 and a.policy is not None
    res = a.deploy(n_episodes=2, enable_save_replay=True)
    paths = sorted(glob.glob(str(tmp_path / "exp" / "replays" / "episode_*.npz")))
    assert len(paths) == len(res["episode_returns"]) >= 2
    check_replays([str(tmp_path / "exp" / "replays" / f"episode_{i}.npz")
                   for i in range(len(paths))], res["episode_returns"])
    # a fresh agent loads the trained checkpoint
    b = agent.MuZeroAgent(cfg=tiny_cartpole(tmp_path / "exp2"), device="cpu")
    res2 = b.batch_evaluate(n_episodes=2, model_path=str(tmp_path / "exp" / "ckpt" / "ckpt_final"))
    assert res2["episode_returns"]
    for p, q in zip(b.policy.model.parameters(), a.policy.model.parameters()):
        assert torch.equal(p, q)


def test_bundled_agent_builds_from_env_id(tmp_path):
    a = agent.MuZeroAgent("gym_cartpole_v0", exp_name=str(tmp_path / "x"), device="cpu")
    assert a.cfg.policy.num_simulations == 25 and a.cfg.exp_name == str(tmp_path / "x")
    legacy = agent.MuZeroAgent("CartPole-v0", device="cpu")
    assert legacy.cfg.exp_name == "data_agent/muzero_CartPole-v0_seed0"
    with pytest.raises(KeyError, match="no bundled muzero config"):
        agent.MuZeroAgent("no_such_env", device="cpu")


def test_replay_files_have_jax_s_keys_dtypes_and_shapes(tmp_path):
    jcfg = JaxMuZeroPolicy.default_config()
    jcfg.model.update(latent_state_dim=8, proj_hid=16, proj_out=16, pred_hid=8, pred_out=16)
    jcfg.num_simulations = 2
    jpolicy = JaxMuZeroPolicy(jcfg)
    jstate = jpolicy.init_train_state(jax.random.PRNGKey(0))
    JaxEvaluator(JaxCartPoleEnv(max_episode_steps=6), jpolicy, num_envs=2, rollout_length=8).eval(
        jstate.params, n_episodes=2, save_replay_path=str(tmp_path / "jax"))
    policy = MuZeroPolicy(dict(model=dict(latent_state_dim=8, proj_hid=16, proj_out=16,
                                          pred_hid=8, pred_out=16), num_simulations=2),
                          device="cpu")
    Evaluator(CartPoleEnv(max_episode_steps=6), policy, num_envs=2, device="cpu").eval(
        n_episodes=2, save_replay_path=str(tmp_path / "port"))
    got, exp = np.load(tmp_path / "port" / "episode_0.npz"), np.load(tmp_path / "jax" / "episode_0.npz")
    assert sorted(got.files) == sorted(exp.files)
    for k in exp.files:
        assert got[k].dtype == exp[k].dtype and got[k].shape[1:] == exp[k].shape[1:], k
    check_replays(sorted(glob.glob(str(tmp_path / "port" / "*.npz"))))


def test_alphazero_evaluation_fails_in_jax_and_is_refused(tmp_path):
    with pytest.raises(TypeError, match="missing 1 required positional argument: 'env'"):
        JaxAlphaZeroAgent("tictactoe_play_with_bot", exp_name=str(tmp_path / "j")).batch_evaluate(
            n_episodes=1)
    a = agent.AlphaZeroAgent("tictactoe_play_with_bot", exp_name=str(tmp_path / "p"), device="cpu")
    with pytest.raises(ValueError, match="missing 1 required positional argument"):
        a.batch_evaluate(n_episodes=1)


def host_cfg(exp_dir):
    return dict(exp_name=str(exp_dir),
                env=dict(env_id="MountainCar-v0", collector_env_num=2, evaluator_env_num=2),
                policy=dict(model=dict(observation_shape=2, action_space_size=3,
                                       latent_state_dim=16), num_simulations=2))


def test_host_env_replay_fails_in_jax_and_is_refused(tmp_path):
    pytest.importorskip("gymnasium")
    j = JaxMuZeroAgent(cfg=JaxConfig(host_cfg(tmp_path / "j")))
    with pytest.raises(TypeError, match="unexpected keyword argument 'save_replay_path'"):
        j.deploy(enable_save_replay=True, replay_path=str(tmp_path / "j" / "r"))
    a = agent.MuZeroAgent(cfg=Config(host_cfg(tmp_path / "p")), device="cpu")
    with pytest.raises(ValueError, match="unexpected keyword argument 'save_replay_path'"):
        a.deploy(enable_save_replay=True, replay_path=str(tmp_path / "p" / "r"))
    assert not os.path.exists(tmp_path / "p" / "r")
    # without replays the host evaluator runs
    res = a.batch_evaluate(n_episodes=1)
    assert len(res["episode_returns"]) == 1


def test_agent_without_device_raises_with_no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        agent.MuZeroAgent("gym_cartpole_v0")
