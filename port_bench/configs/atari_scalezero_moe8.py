"""ScaleZero's multitask Atari world model (``atari_scalezero_moe8.json``):
UniZero's conv encoder and transformer with a mixture-of-experts
feed-forward in every block, built through ``UniZeroMTPolicy`` with weights
drawn from the seed on the device, and a learn step's operations from
shapes, counting the routed work."""
from __future__ import annotations

import torch

from port_bench import flops, harness

WEIGHTS_KEY = 1


def build(config: dict, seed: int, device: str):
    """(the policy, the weights it was given). The model is laid out on the
    meta device, so no weight is drawn on the host, then filled with the
    benchmark's weights on ``device``. A program whose model has no shared
    expert is refused before anything is drawn: it would run another
    model. The gates are drawn like every other weight; at top-1 they take
    no gradient, so the experts' load stays what the draw gives (the
    configuration's ``assumed``)."""
    from lightzero_tpu_torch.config import Config
    from lightzero_tpu_torch.models.unizero import UniZeroModel
    from lightzero_tpu_torch.policy.multitask import UniZeroMTPolicy

    cfg = Config(config["policy"])
    model_cfg = Config(dict(cfg.model))
    scale = int(model_cfg.support_scale)
    model_cfg.value_support_size = model_cfg.reward_support_size = 2 * scale + 1
    with torch.device("meta"):
        model = UniZeroModel.from_config(model_cfg)
    if not any(".moe.shared." in name for name, _ in model.named_parameters()):
        raise RuntimeError("the program's UniZero model has no shared expert "
                           "(model.n_shared_experts): it cannot run this configuration")
    weights = harness.draw_weights(model, harness.derive(seed, WEIGHTS_KEY), device)
    model = model.to_empty(device=device)
    model.load_state_dict(weights)
    return UniZeroMTPolicy(cfg, model=model, device=device), weights


def flops_forward(config: dict, batch: int) -> tuple:
    """(the forward pass's operations for ``batch`` rows of the unroll, the
    part of them in the first convolution, which takes no input gradient).
    Each token passes through its ``num_experts_per_tok`` routed experts and
    the shared ones, not through every expert."""
    p = config["policy"]
    m = p["model"]
    H, W, c_in = m["observation_shape"]
    c, D, A = int(m["num_channels"]), int(m["embed_dim"]), int(m["action_space_size"])
    E, k = int(m["num_experts"]), int(m["num_experts_per_tok"])
    support = 2 * int(m["support_scale"]) + 1
    K = int(p["num_unroll_steps"])
    frames = batch * (K + 1)
    h, w = flops.latent_hw(m["observation_shape"])
    encoder = (flops.downsample(H, W, c_in, c) + flops.res_blocks(h, w, c, 1)
               + flops.linear(h * w * c, D))
    T = 2 * K + 1
    swiglu = 3 * flops.linear(D, 4 * D)
    per_token = (flops.linear(D, 3 * D) + flops.linear(D, D) + flops.linear(D, E)
                 + (k + int(m.get("n_shared_experts", 0))) * swiglu)
    attention = 2 * 2.0 * T * T * D  # scores and the weighted sum, per row
    blocks = int(m["num_layers"]) * (batch * T * per_token + batch * attention)
    head = flops.linear(D, D)
    obs_heads = (K + 1) * batch * (2 * head + flops.linear(D, support) + flops.linear(D, A))
    act_heads = K * batch * (2 * head + flops.linear(D, support) + flops.linear(D, D))
    first = frames * flops.conv(flops.ceil_half(H), flops.ceil_half(W), c_in, c // 2, 3)
    return frames * encoder + blocks + obs_heads + act_heads, first


def flops_learn_step(config: dict, batch: int) -> float:
    """Forward and backward: the backward takes twice the forward's
    operations (the input's and the weight's gradient of every product,
    the gate's too, whose gradient is zero at k = 1 but is computed),
    except the first convolution's input gradient, which is not needed."""
    fwd, first = flops_forward(config, batch)
    return 3 * fwd - first
