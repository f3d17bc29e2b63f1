"""Atari MuZero (``atari_muzero.json``): the conv model with the DownSample
pyramid, built through ``MuZeroPolicy`` with weights drawn from the seed on
the device, and its operations from shapes."""
from __future__ import annotations

import torch

from port_bench import flops, harness

WEIGHTS_KEY = 1


def build(config: dict, seed: int, device: str):
    """(the policy, the weights it was given). The model is laid out on the
    meta device, so no weight is drawn on the host, then filled with the
    benchmark's weights on ``device``."""
    from lightzero_tpu_torch.config import Config
    from lightzero_tpu_torch.models import MuZeroModel
    from lightzero_tpu_torch.policy import MuZeroPolicy

    cfg = Config(config["policy"])
    model_cfg = Config(dict(cfg.model))
    scale = int(model_cfg.support_scale)
    model_cfg.value_support_size = model_cfg.reward_support_size = 2 * scale + 1
    with torch.device("meta"):
        model = MuZeroModel.from_config(model_cfg)
    weights = harness.draw_weights(model, harness.derive(seed, WEIGHTS_KEY), device)
    model = model.to_empty(device=device)
    model.load_state_dict(weights)
    return MuZeroPolicy(cfg, model=model, device=device), weights


def _widths(config: dict):
    m = config["policy"]["model"]
    h, w = flops.latent_hw(m["observation_shape"])
    return m, h, w, int(m["num_channels"]), int(m["num_res_blocks"]), 2 * int(m["support_scale"]) + 1


def _prediction(config: dict) -> float:
    m, h, w, c, n, support = _widths(config)
    return (flops.res_blocks(h, w, c, n)
            + flops.conv_head(h, w, c, 16, m["value_head_hidden_channels"][0], support)
            + flops.conv_head(h, w, c, 16, m["policy_head_hidden_channels"][0],
                              int(m["action_space_size"])))


def flops_initial(config: dict) -> float:
    """The initial inference of one root: the representation and the
    prediction."""
    m, h, w, c, n, _ = _widths(config)
    H, W, c_in = m["observation_shape"]
    return flops.downsample(H, W, c_in, c) + flops.res_blocks(h, w, c, n) + _prediction(config)


def flops_recurrent(config: dict) -> float:
    """One recurrent inference of one tree: the dynamics with the reward
    head, and the prediction."""
    m, h, w, c, n, support = _widths(config)
    A = int(m["action_space_size"])
    return (flops.conv(h, w, c + A, c, 3) + flops.res_blocks(h, w, c, n)
            + flops.conv_head(h, w, c, 16, m["reward_head_hidden_channels"][0], support)
            + _prediction(config))
