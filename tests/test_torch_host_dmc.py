"""The DMC configs through the port's train_muzero on the CPU
(lightzero_tpu_torch/envs/dmc2gym_env.py under entry/train_muzero.py's host
path), shrunk as tests/test_torch_host_configs.py shrinks them, episodes of
125 steps (a frame skip of 8 over dm_control's 1000 control steps).

- The three state configs (Sampled EfficientZero, Sampled MuZero, Sampled
  UniZero on cartpole swingup) train 2 learn steps after an eval and a
  collect round of whole episodes.
- The pixel config (Sampled EfficientZero's conv model on rendered 84x84
  frames) runs in a process of its own with MUJOCO_GL=egl: dm_control's
  renderer must not run in a test worker, whose death would lose the file.
"""
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from lightzero_tpu_torch.entry import train_muzero
from test_torch_host_configs import check_run, shrunk

pytestmark = pytest.mark.unittest

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", ["dmc2gym_state_sez", "dmc2gym_state_smz", "dmc2gym_state_suz"])
def test_dmc_state_config_trains_shrunk_through_the_port(tmp_path, name):
    cfg = shrunk(name, tmp_path / "exp")
    policy, state, stats = train_muzero(cfg, seed=0, max_train_iter=2, device="cpu")
    check_run(tmp_path, policy, state, stats)
    # two envs: one collect round and one eval of whole 125-step episodes
    assert stats["env_steps"] == 2 * 125 and stats["eval_env_steps"] == 125
    ep = stats["buffer"]._episodes[0]
    assert ep.obs.shape == (125, 5) and ep.actions.shape == (125, 1)


_PIXELS = """
import copy, json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from lightzero_tpu_torch.configs.dmc2gym_pixels_sez import main_config
from lightzero_tpu_torch.entry import train_muzero
cfg = copy.deepcopy(main_config)
cfg.exp_name = sys.argv[1]
cfg.env.update(collector_env_num=2, evaluator_env_num=2, stop_value=1e9,
               env_kwargs=dict(cfg.env.env_kwargs, frame_skip=8))
cfg.policy.model.update(num_channels=4, lstm_hidden_size=16)
cfg.policy.update(num_simulations=4, num_of_sampled_actions=3, batch_size=8,
                  update_per_collect=2, n_episode=2, eval_freq=1000)
policy, state, stats = train_muzero(cfg, seed=0, max_train_iter=2, device="cpu")
ep = stats["buffer"]._episodes[0]
print(json.dumps(dict(train_iter=stats["train_iter"], env_steps=stats["env_steps"],
                      eval_env_steps=stats["eval_env_steps"], obs_shape=list(ep.obs.shape),
                      obs_max=float(ep.obs.max()),
                      finite=all(bool(torch.isfinite(p).all()) for p in state.model.parameters()))))
"""


def test_dmc_pixel_config_trains_shrunk_in_its_own_process(tmp_path):
    import json

    env = dict(os.environ, MUJOCO_GL="egl", PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _PIXELS, str(tmp_path / "exp")], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rec["train_iter"] == 2 and rec["finite"]
    assert rec["env_steps"] == 250 and rec["eval_env_steps"] == 125
    assert rec["obs_shape"] == [125, 84, 84, 3] and 0 < rec["obs_max"] <= 255
