"""AlphaZero's policy and value network (``lightzero_tpu/models/alphazero.py``)
over NHWC board planes: conv 3x3 without bias -> LayerNorm over the channels
-> relu -> ``num_res_blocks`` ResBlocks, then two ``MLPTorso`` heads over the
(h, w, c) flatten, the policy's logits and the value, squashed by tanh into
[-1, 1]. The lists ``conv``, ``norm``, ``res`` and ``mlp`` hold flax's
``Conv_0``, ``LayerNorm_0``, ``ResBlock_i`` and ``MLPTorso_0`` (policy),
``MLPTorso_1`` (value), which ``utils/params_import.py`` maps."""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from lightzero_tpu_torch.models.common import ConvNHWC, MLPTorso, ResBlock, _layer_norm


class AlphaZeroModel(nn.Module):
    def __init__(
        self,
        observation_shape: Sequence[int] = (3, 3, 3),
        action_space_size: int = 9,
        num_channels: int = 32,
        num_res_blocks: int = 1,
        value_head_hidden_channels: Sequence[int] = (32,),
        policy_head_hidden_channels: Sequence[int] = (32,),
        norm_type: str = "LN",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        h, w, c = (int(n) for n in observation_shape)
        self.observation_shape = (h, w, c)
        self.action_space_size = action_space_size
        self.conv = nn.ModuleList([ConvNHWC(c, num_channels, generator=generator)])
        self.norm = nn.ModuleList([_layer_norm(num_channels)])
        self.res = nn.ModuleList(ResBlock(num_channels, generator) for _ in range(num_res_blocks))
        flat = h * w * num_channels
        self.mlp = nn.ModuleList([
            MLPTorso(flat, tuple(policy_head_hidden_channels), action_space_size,
                     norm_type=norm_type, last_linear_layer_init_zero=True, generator=generator),
            MLPTorso(flat, tuple(value_head_hidden_channels), 1,
                     norm_type=norm_type, last_linear_layer_init_zero=True, generator=generator),
        ])

    def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """obs (B, H, W, C) -> (policy logits (B, A), value (B,) in [-1, 1])."""
        x = torch.relu(self.norm[0](self.conv[0](obs)))
        for block in self.res:
            x = block(x)
        flat = x.reshape(x.shape[0], -1)
        return self.mlp[0](flat), torch.tanh(self.mlp[1](flat)[..., 0])

    @staticmethod
    def from_config(model_cfg, generator: Optional[torch.Generator] = None) -> "AlphaZeroModel":
        return AlphaZeroModel(
            observation_shape=tuple(model_cfg.get("observation_shape", (3, 3, 3))),
            action_space_size=model_cfg.get("action_space_size", 9),
            num_channels=model_cfg.get("num_channels", 32),
            num_res_blocks=model_cfg.get("num_res_blocks", 1),
            norm_type=model_cfg.get("norm_type", "LN"),
            generator=generator,
        )
