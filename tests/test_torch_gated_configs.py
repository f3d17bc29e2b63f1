"""The zoo configs of the gated host envs, copied into
lightzero_tpu_torch/configs/: Atari (10), MiniGrid (3), Jericho, MetaDrive
and pooltool's sum-to-three.

- Each equals its zoo file key for key, as tests/test_torch_host_configs.py
  holds the other copies.
- A run of each through the port's ``train_muzero`` ends in the gated
  adapter's ImportError before any policy is built, since the env's
  library (ale_py, minigrid, jericho, metadrive, pooltool) is absent here
  and on the card's machine (the JAX Atari adapter fails later, in
  gymnasium's NamespaceNotFound); the Atari config with gymnasium's old id
  ends in gymnasium's NameNotFound here. The RND config goes through
  ``train_muzero_with_reward_model``, which refuses host envs (ROADMAP
  queue 3).
"""
import copy
import importlib
import importlib.util

import pytest

from lightzero_tpu.config import Config as JaxConfig
from lightzero_tpu_torch.entry import train_muzero, train_muzero_with_reward_model

pytestmark = pytest.mark.unittest

GATED = {
    **{f"atari_{n}": (f"atari.config.atari_{n}_config", "ale_py") for n in (
        "efficientzero", "gumbel_muzero", "muzero", "muzero_context", "muzero_rnn_fullobs",
        "muzero_stack1", "rezero_mz", "stochastic_muzero", "unizero", "unizero_moe")},
    **{f"minigrid_{n}": (f"minigrid.config.minigrid_{n}_config", "minigrid") for n in (
        "efficientzero", "muzero", "muzero_rnd")},
    "jericho_unizero": ("jericho.config.jericho_unizero_config", "jericho"),
    "metadrive_sampled_efficientzero": (
        "metadrive.config.metadrive_sampled_efficientzero_config", "metadrive"),
    "sum_to_three_vector_obs_sez": ("pooltool.config.sum_to_three_vector_obs_sez_config",
                                    "pooltool"),
}


def port_config(name):
    return importlib.import_module(f"lightzero_tpu_torch.configs.{name}").main_config


def test_sixteen_gated_configs():
    assert len(GATED) == 16


@pytest.mark.parametrize("name", sorted(GATED))
def test_config_equals_the_zoo_file(name):
    zoo = importlib.import_module(f"zoo.{GATED[name][0]}").main_config
    assert port_config(name).to_dict() == JaxConfig(zoo).to_dict()


@pytest.mark.parametrize("name", sorted(n for n in GATED if n != "minigrid_muzero_rnd"))
def test_run_ends_in_the_adapter_s_import_error(tmp_path, name):
    """Before any policy is built. The Atari config with gymnasium's old id
    'PongNoFrameskip-v4' is no ``ALE/`` id, so it reaches gymnasium itself
    (as in JAX): ImportError without gymnasium, as on the card's machine,
    NameNotFound without ale_py's ids, as here."""
    library = GATED[name][1]
    if importlib.util.find_spec(library) is not None:
        pytest.skip(f"{library} is installed, so the adapter is not gated here")
    expected = ImportError
    if name == "atari_unizero_moe" and importlib.util.find_spec("gymnasium") is not None:
        import gymnasium

        expected = gymnasium.error.NameNotFound
    cfg = copy.deepcopy(port_config(name))
    cfg.exp_name = str(tmp_path / "exp")
    with pytest.raises(expected):
        train_muzero(cfg, device="cpu", max_env_step=1)
    assert not (tmp_path / "exp" / "ckpt").exists() or not any((tmp_path / "exp" / "ckpt").iterdir())


def test_the_rnd_config_on_a_host_env_is_refused(tmp_path):
    """train_muzero_with_reward_model runs tensor envs only: the JAX entry
    fails on a host env (ROADMAP queue 3) and the port refuses it."""
    cfg = copy.deepcopy(port_config("minigrid_muzero_rnd"))
    cfg.exp_name = str(tmp_path / "exp")
    with pytest.raises(ValueError, match="host env"):
        train_muzero_with_reward_model(cfg, device="cpu", max_env_step=1)
