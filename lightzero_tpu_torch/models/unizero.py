"""UniZero model: a tokenizer (observation encoder, action embedding) and the
transformer world model over the interleaved token sequence
o_0, a_0, o_1, a_1, ..., o_K (``lightzero_tpu/models/unizero.py``).

Value and policy heads read the obs-token positions, the reward head and the
next-observation head (``obs_head``, then the latent norm) the action-token
positions. Inference goes token by token through a ``KVCache``:
``infer_obs_step`` appends an observation's embedding, ``infer_action_step``
an action's; ``prefill`` teacher-forces a history into a fresh cache (the
context of a reanalyze root).

Encoders: an MLP for vector observations, the conv ResNet of
``models/common.py`` plus a Dense for images, or the ViT
(``encoder_type='vit'``); the latent norm is SimNorm (groups of 8) or the
eps-1e-6 LayerNorm. Discrete actions are embedded by a table, continuous ones
(Sampled UniZero) by a Dense, with Gaussian heads (``policy_params``). The
optional decoder (``with_decoder``) maps an embedding back to an
observation: an MLP, or a Dense, flax-rule ``ConvTranspose`` layers and a
SAME conv for images.

flax's ``ConvTranspose`` (padding SAME, ``transpose_kernel=False``) is a
plain correlation of the unflipped kernel over the input dilated by the
stride and padded (k + s - 2) in total, ceil of half of it before when
s <= k - 1 and k - 1 before otherwise (``lax.conv_transpose``): an output of
n * s. ``torch.nn.ConvTranspose2d`` flips the kernel and sizes its output
another way, so ``ConvTransposeNHWC`` dilates, pads and correlates itself.

Parameter names follow flax's, mapped by ``utils/params_import.py``: the
tops as ``_UZ_TOPS`` there says (``_wm`` -> ``transformer``, ...), a numbered
flax submodule ``X_i`` as the list entry ``x.i``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from lightzero_tpu_torch.models.common import (
    LAYER_NORM_EPS,
    ConvNHWC,
    MLPTorso,
    RepresentationNetworkConv,
    SimNorm,
    conv_latent_shape,
    lecun_normal_,
)
from lightzero_tpu_torch.models.unizero_world_model.transformer import (
    KVCache,
    Transformer,
    TransformerConfig,
    init_kv_cache,
)

Outputs = Dict[str, torch.Tensor]


class ConvSameBias(ConvNHWC):
    """flax ``nn.Conv(out, (k, k), padding="SAME")`` with its bias."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__(in_channels, out_channels, kernel, 1, generator)
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x) + self.bias


def conv_transpose_padding(k: int, s: int) -> Tuple[int, int]:
    """``lax.conv_transpose``'s SAME padding of the dilated input."""
    pad_len = k + s - 2
    before = k - 1 if s > k - 1 else int(math.ceil(pad_len / 2))
    return before, pad_len - before


class ConvTransposeNHWC(nn.Module):
    """flax ``nn.ConvTranspose(out, (k, k), strides=(s, s))`` (padding SAME,
    kernel unflipped, bias) on NHWC tensors; ``weight`` is (out, in, k, k)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3, stride: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel, self.stride = kernel, stride
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        lecun_normal_(self.weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        s = self.stride
        dilated = x.new_zeros((B, C, (H - 1) * s + 1, (W - 1) * s + 1))
        dilated[:, :, ::s, ::s] = x.permute(0, 3, 1, 2)
        before, after = conv_transpose_padding(self.kernel, s)
        y = F.conv2d(F.pad(dilated, (before, after, before, after)), self.weight, self.bias)
        return y.permute(0, 2, 3, 1)


class UniZeroModel(nn.Module):
    def __init__(
        self,
        observation_shape: Any = 4,
        action_space_size: int = 2,
        continuous_action: bool = False,
        obs_type: str = "vector",
        embed_dim: int = 256,
        num_layers: int = 2,
        num_heads: int = 8,
        max_tokens: int = 32,
        context_window: int = 0,
        value_support_size: int = 601,
        reward_support_size: int = 601,
        norm_type: str = "LN",
        last_linear_layer_init_zero: bool = True,
        simnorm_dim: int = 8,
        latent_norm: str = "SimNorm",
        num_channels: int = 64,
        downsample: bool = True,
        with_decoder: bool = False,
        encoder_type: str = "conv",
        moe_in_transformer: bool = False,
        num_experts: int = 4,
        num_experts_per_tok: int = 1,
        n_shared_experts: int = 0,
        num_tasks: int = 0,
        lora_r: int = 0,
        curriculum_stage_num: int = 1,
        curriculum_stage: int = 0,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        D = embed_dim
        g = generator
        self.observation_shape = observation_shape
        self.action_space_size = action_space_size
        self.continuous_action = continuous_action
        self.obs_type = obs_type
        self.embed_dim = embed_dim
        self.num_layers, self.num_heads, self.max_tokens = num_layers, num_heads, max_tokens
        self.context_window = context_window
        self.num_channels, self.downsample = num_channels, downsample
        self.encoder_type = encoder_type
        self.tcfg = TransformerConfig(
            num_layers=num_layers, num_heads=num_heads, embed_dim=D, max_tokens=max_tokens,
            context_window=context_window, moe_in_transformer=moe_in_transformer,
            num_experts=num_experts, num_experts_per_tok=num_experts_per_tok,
            n_shared_experts=n_shared_experts, num_tasks=num_tasks, lora_r=lora_r,
            curriculum_stage_num=curriculum_stage_num, curriculum_stage=curriculum_stage,
        )
        if obs_type == "vector":
            self.encoder = MLPTorso(int(observation_shape), (D,), D, norm_type=norm_type,
                                    output_norm=True, generator=g)
        elif encoder_type == "vit":
            from lightzero_tpu_torch.models.vit import ViT

            self.encoder_vit = ViT(tuple(observation_shape), out_dim=D, generator=g)
        else:
            self.encoder_conv = RepresentationNetworkConv(
                observation_shape[-1], num_channels, downsample=downsample, generator=g)
            h, w, c = conv_latent_shape(observation_shape, num_channels, downsample)
            self.encoder_proj = nn.Linear(h * w * c, D)
            lecun_normal_(self.encoder_proj.weight, g)
            nn.init.zeros_(self.encoder_proj.bias)
        if latent_norm == "SimNorm":
            self.latent_norm = SimNorm(simnorm_dim)
        else:
            self.latent_norm = nn.LayerNorm(D, eps=LAYER_NORM_EPS)
        if continuous_action:
            self.action_embed_dense = nn.Linear(action_space_size, D)
            lecun_normal_(self.action_embed_dense.weight, g)
            nn.init.zeros_(self.action_embed_dense.bias)
            # zero-init Gaussian heads (sigma ~ 1.05 at init)
            self.mu_head = MLPTorso(D, (D,), action_space_size, norm_type=norm_type,
                                    last_linear_layer_init_zero=True, generator=g)
            self.sigma_head = MLPTorso(D, (D,), action_space_size, norm_type=norm_type,
                                       last_linear_layer_init_zero=True, generator=g)
        else:
            self.action_embed = nn.Embedding(action_space_size, D)
            with torch.no_grad():
                self.action_embed.weight.normal_(0.0, 1.0 / math.sqrt(D), generator=g)
        self.transformer = Transformer(self.tcfg, g)

        def head(out: int) -> MLPTorso:
            return MLPTorso(D, (D,), out, norm_type=norm_type,
                            last_linear_layer_init_zero=last_linear_layer_init_zero, generator=g)

        self.value_head = head(value_support_size)
        self.policy_head = head(action_space_size)
        self.reward_head = head(reward_support_size)
        self.obs_head = MLPTorso(D, (D,), D, norm_type=norm_type, generator=g)
        if with_decoder:
            if obs_type == "vector":
                self.decoder = MLPTorso(D, (D,), int(observation_shape), norm_type=norm_type,
                                        generator=g)
            else:
                h, w, c = observation_shape
                f = 8 if downsample else 1
                self.decoder_proj = nn.Linear(D, (h // f) * (w // f) * num_channels)
                lecun_normal_(self.decoder_proj.weight, g)
                nn.init.zeros_(self.decoder_proj.bias)
                self.decoder_convs = nn.ModuleList(
                    ConvTransposeNHWC(num_channels, num_channels, 3, 2, g)
                    for _ in range(3 if downsample else 0))
                self.decoder_out = ConvSameBias(num_channels, c, 3, g)
        self.with_decoder = with_decoder
        # the adaptive policy-entropy temperature
        self.log_alpha = nn.Parameter(torch.zeros(()))

    # ------------------------------------------------------------ tokenizer
    def embed_action(self, action: torch.Tensor) -> torch.Tensor:
        if self.continuous_action:
            return self.action_embed_dense(action.to(torch.float32))
        return self.action_embed(action.long())

    def policy_params(self, h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mu, sigma): mu in (-1.5, 1.5), sigma in (0.1, 2.0)."""
        mu = 1.5 * torch.tanh(self.mu_head(h))
        sigma = 0.1 + 1.9 * torch.sigmoid(self.sigma_head(h))
        return mu, sigma

    def encode_obs(self, obs: torch.Tensor) -> torch.Tensor:
        """(B, *obs) -> (B, D) normalised embedding."""
        if self.obs_type == "vector":
            e = self.encoder(obs)
        elif self.encoder_type == "vit":
            e = self.encoder_vit(obs)
        else:
            e = self.encoder_conv(obs)
            e = self.encoder_proj(e.reshape(e.shape[0], -1))
        return self.latent_norm(e)

    def decode_obs(self, emb: torch.Tensor) -> torch.Tensor:
        """(B, D) embedding -> reconstructed observation (NHWC for images)."""
        if self.obs_type == "vector":
            return self.decoder(emb)
        h, w, _ = self.observation_shape
        f = 8 if self.downsample else 1
        x = self.decoder_proj(emb).reshape(emb.shape[0], h // f, w // f, self.num_channels)
        for conv in self.decoder_convs:
            x = torch.relu(conv(x))
        return self.decoder_out(x)[:, :h, :w, :]

    def _encode_seq(self, obs_seq: torch.Tensor) -> torch.Tensor:
        B, T = obs_seq.shape[:2]
        return self.encode_obs(obs_seq.reshape(B * T, *obs_seq.shape[2:])).reshape(B, T, -1)

    def _interleave(self, obs_e: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
        """[o_0, a_0, o_1, ..., o_K]: (B, 2K + 1, D)."""
        B, K1, D = obs_e.shape
        act_e = self.embed_action(actions).to(obs_e.dtype)
        tokens = obs_e.new_zeros((B, 2 * K1 - 1, D))
        tokens[:, 0::2] = obs_e
        tokens[:, 1::2] = act_e
        return tokens

    # ------------------------------------------------------- train forward
    def train_forward(self, obs_seq: torch.Tensor, actions: torch.Tensor,
                      task_id: Optional[torch.Tensor] = None) -> Outputs:
        """obs_seq (B, K+1, *obs), actions (B, K) -> value and policy logits at
        the K+1 obs positions, reward logits and ``obs_pred`` at the K action
        positions, and the obs embeddings."""
        return self.train_forward_embedded(self._encode_seq(obs_seq), actions, task_id)

    def train_forward_embedded(self, obs_e: torch.Tensor, actions: torch.Tensor,
                               task_id: Optional[torch.Tensor] = None) -> Outputs:
        """``train_forward`` on obs tokens already embedded (B, K+1, D): the
        drift correction feeds the model's own predicted embeddings."""
        B, K1 = obs_e.shape[:2]
        T = 2 * K1 - 1
        pos = torch.arange(T, device=obs_e.device).expand(B, T)
        x, _ = self.transformer(self._interleave(obs_e, actions), pos, None, task_id)
        obs_pos, act_pos = x[:, 0::2], x[:, 1::2]
        out = dict(
            value_logits=self.value_head(obs_pos),
            policy_logits=self.policy_head(obs_pos),
            reward_logits=self.reward_head(act_pos),
            obs_pred=self.latent_norm(self.obs_head(act_pos)),
            obs_embeddings=obs_e,
        )
        if self.continuous_action:
            out["mu"], out["sigma"] = self.policy_params(obs_pos)
        return out

    # --------------------------------------------------------- infer steps
    def _obs_heads(self, h: torch.Tensor) -> Outputs:
        res = dict(value_logits=self.value_head(h), policy_logits=self.policy_head(h), latent=h)
        if self.continuous_action:
            res["mu"], res["sigma"] = self.policy_params(h)
        return res

    def infer_obs_step(self, cache: KVCache, obs_embedding: torch.Tensor,
                       task_id: Optional[torch.Tensor] = None) -> Tuple[Outputs, KVCache]:
        """Append an obs token: the value and policy heads there."""
        out, cache = self.transformer(obs_embedding[:, None, :], cache.next_pos[:, None], cache,
                                      task_id)
        return self._obs_heads(out[:, 0]), cache

    def infer_action_step(self, cache: KVCache, action: torch.Tensor,
                          task_id: Optional[torch.Tensor] = None) -> Tuple[Outputs, KVCache]:
        """Append an action token: the reward logits and the predicted next
        obs embedding there."""
        x = self.embed_action(action)[:, None, :]
        out, cache = self.transformer(x, cache.next_pos[:, None], cache, task_id)
        h = out[:, 0]
        return dict(reward_logits=self.reward_head(h),
                    obs_pred=self.latent_norm(self.obs_head(h))), cache

    def init_cache(self, batch_size: int, device=None) -> KVCache:
        return init_kv_cache(self.tcfg, batch_size,
                             device=device or self.log_alpha.device)

    def prefill(self, obs_seq: torch.Tensor, actions: torch.Tensor, length: torch.Tensor,
                task_id: Optional[torch.Tensor] = None) -> Tuple[Outputs, KVCache]:
        """Teacher-force an (obs, action) history into a fresh cache: the obs
        heads at the final obs token, and the cache. obs_seq (B, H+1, *obs),
        actions (B, H); ``length`` (B,) valid history steps per row
        (0 <= length <= H). Every row ends at the same token; a row's tokens
        before its history take position -1 and are masked out."""
        B, H1 = obs_seq.shape[:2]
        H = H1 - 1
        tokens = self._interleave(self._encode_seq(obs_seq), actions)
        T = 2 * H + 1
        pos = torch.arange(T, device=tokens.device).expand(B, T)
        start = 2 * (H - length.long().to(tokens.device))[:, None]
        pos = torch.where(pos >= start, pos - start, -1)
        x, cache = self.transformer(tokens, pos, self.init_cache(B, tokens.device), task_id)
        return self._obs_heads(x[:, -1]), cache

    @staticmethod
    def from_config(model_cfg: Any, generator: Optional[torch.Generator] = None
                    ) -> "UniZeroModel":
        """Build from a ``cfg.policy.model`` tree (the JAX package's key
        names; ``world_model_cfg`` entries first)."""
        obs_shape = model_cfg.get("observation_shape", 4)
        if isinstance(obs_shape, (list, tuple)):
            obs_shape, obs_type = tuple(obs_shape), "image"
        else:
            obs_type = "vector"
        wm = model_cfg.get("world_model_cfg", {}) or {}

        def pick(key: str, default, model_key: Optional[str] = None):
            return wm.get(key, model_cfg.get(model_key or key, default))

        kwargs = dict(
            observation_shape=obs_shape,
            action_space_size=model_cfg.get("action_space_size", 2),
            continuous_action=model_cfg.get("continuous_action_space", False),
            obs_type=model_cfg.get("obs_type", obs_type),
            embed_dim=pick("embed_dim", 256),
            num_layers=pick("num_layers", 2),
            num_heads=pick("num_heads", 8),
            max_tokens=pick("max_tokens", 32),
            context_window=int(wm.get("context_length", model_cfg.get("context_window", 0))),
            norm_type=model_cfg.get("norm_type", "LN"),
            num_channels=model_cfg.get("num_channels", 64),
            downsample=model_cfg.get("downsample", True),
            with_decoder=bool(model_cfg.get("with_decoder", False)),
            encoder_type=model_cfg.get("encoder_type", wm.get("encoder_type", "conv")),
            moe_in_transformer=bool(pick("moe_in_transformer", False)),
            num_experts=int(pick("num_experts", 4)),
            num_experts_per_tok=int(pick("num_experts_per_tok", 1)),
            n_shared_experts=int(pick("n_shared_experts", 0)),
            latent_norm=str(wm.get("final_norm_option_in_encoder",
                                   model_cfg.get("final_norm_option_in_encoder",
                                                 model_cfg.get("latent_norm", "SimNorm")))),
            num_tasks=int(pick("num_tasks", 0)),
            lora_r=int(pick("lora_r", 0)),
            curriculum_stage_num=int(pick("curriculum_stage_num", 1)),
            curriculum_stage=int(pick("curriculum_stage", 0)),
        )
        for k in ("value_support_size", "reward_support_size"):
            if k in model_cfg:
                kwargs[k] = model_cfg[k]
        return UniZeroModel(**kwargs, generator=generator)
