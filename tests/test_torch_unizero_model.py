"""Port vs JAX: the UniZero modules (lightzero_tpu_torch/models/
unizero_world_model/transformer.py and moe.py, models/vit.py, models/
unizero.py, SimNorm in models/common.py and UniZero's maps in
utils/params_import.py against their counterparts in lightzero_tpu/), at
small widths: embed 32, 2 layers, 4 heads.

Weights are flax's init perturbed from a numpy seed (so that zero-init last
layers, zero LoRA factors and unit LayerNorm scales become informative),
carried across by the importer; inputs are numpy-seeded. Outputs agree to
TOL = 1e-5 relative and absolute (float32 matmuls, softmaxes and LayerNorm
statistics in another order); cache positions exactly.

- SimNorm and RoPE on the same inputs;
- the train forward (the interleaved causal pass), and the incremental path
  token by token across a ring wrap (10 tokens into 6 slots), with and
  without ``context_window``: every step's heads and the final cache;
- the MoE with tied gate logits (experts 0 and 1 share their gate column),
  whose tie rule keeps both where ``torch.topk`` keeps one;
- CurriculumLoRA at stages 0, 1 and 2, and the trainable masks over the
  port's names against the JAX masks over flax's;
- the ViT encoder; both decoders, and flax's ConvTranspose rule at even and
  odd sizes;
- the import, exact both ways for every branch (conv, ViT, MoE, LoRA,
  task embedding, decoders, continuous heads), and refusing what it does
  not know;
- prefill at full history, against JAX and against the port's own token by
  token inference;
- the JAX prefill fault (ROADMAP queue 3): with 2 layers a history shorter
  than H gives NaN in JAX; the port's prefill of it equals JAX's prefill of
  the history cut to its length (heads and cache);
- a ring write of more tokens than slots keeps the latest position in each.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightzero_tpu.models import common as jax_common
from lightzero_tpu.models.unizero import UniZeroModel as JaxUniZero
from lightzero_tpu.models.unizero_world_model import moe as jax_moe
from lightzero_tpu.models.unizero_world_model import transformer as jax_tf
from lightzero_tpu.models.vit import ViT as JaxViT
from lightzero_tpu_torch.models.common import SimNorm
from lightzero_tpu_torch.models.unizero import ConvTransposeNHWC, UniZeroModel
from lightzero_tpu_torch.models.unizero_world_model import moe, transformer
from lightzero_tpu_torch.utils.params_import import (
    _unizero_port_name,
    flax_to_state_dict,
    state_dict_to_flax,
)

pytestmark = pytest.mark.unittest

TOL = 1e-5
SMALL = dict(observation_shape=4, action_space_size=2, embed_dim=32, num_heads=4, num_layers=2,
             max_tokens=16, value_support_size=11, reward_support_size=11)


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


def close(got, exp, tol=TOL, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(exp), rtol=tol, atol=tol, err_msg=what)


def flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def port_kwargs(kw):
    kw = dict(kw)
    kw["continuous_action"] = kw.pop("continuous_action", False)
    return kw


def make_models(seed=0, **kw):
    """(flax model, perturbed params, port model with those params)."""
    kw = dict(SMALL, **kw)
    jm = JaxUniZero(**kw)
    params = perturb(jm.init_params(jax.random.PRNGKey(seed)), seed)
    port = UniZeroModel(**port_kwargs(kw)).eval()
    port.load_state_dict(flax_to_state_dict(params))
    return jm, params, port


def test_simnorm_matches_flax():
    x = np.random.default_rng(0).standard_normal((3, 5, 32)).astype(np.float32) * 3
    exp = jax_common.SimNorm(8).apply({}, jnp.asarray(x))
    close(SimNorm(8)(torch.from_numpy(x)), exp)


def test_rope_rotates_split_halves_as_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 4, 7, 8)).astype(np.float32)
    pos = rng.integers(-1, 40, (2, 1, 7))
    tables = transformer._rope_tables(torch.from_numpy(pos), 8, 10000.0)
    close(transformer._rotate(torch.from_numpy(x), *tables),
          jax_tf._rope(jnp.asarray(x), jnp.asarray(pos), 10000.0))


def _obs_actions(seed, B, K, obs_shape, A=2, continuous=False):
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal((B, K + 1) + tuple(obs_shape)).astype(np.float32)
    if continuous:
        return obs, rng.uniform(-1, 1, (B, K, A)).astype(np.float32)
    return obs, rng.integers(0, A, (B, K))


def _check_train_forward(jm, params, port, obs, act):
    exp = jm.apply(params, jnp.asarray(obs), jnp.asarray(act), method=JaxUniZero.train_forward)
    with torch.no_grad():
        got = port.train_forward(torch.from_numpy(obs), torch.from_numpy(act))
    assert set(got) == set(exp)
    for k in exp:
        close(got[k], exp[k], what=k)


def test_train_forward_matches_flax():
    jm, params, port = make_models()
    _check_train_forward(jm, params, port, *_obs_actions(2, 3, 5, (4,)))


@pytest.mark.parametrize("window", [0, 4])
def test_incremental_path_across_a_ring_wrap_matches_flax(window):
    """5 steps of (obs, action) tokens into a ring of 6 slots."""
    jm, params, port = make_models(max_tokens=6, context_window=window)
    B, K = 3, 5
    obs, act = _obs_actions(3, B, K, (4,))
    apply = jax.jit(jm.apply, static_argnames="method")
    jc = jm.apply(params, B, method=JaxUniZero.init_cache)
    pc = port.init_cache(B)
    with torch.no_grad():
        for t in range(K):
            je = apply(params, jnp.asarray(obs[:, t]), method=JaxUniZero.encode_obs)
            jr, jc = apply(params, jc, je, method=JaxUniZero.infer_obs_step)
            pr, pc = port.infer_obs_step(pc, port.encode_obs(torch.from_numpy(obs[:, t])))
            for k in jr:
                close(pr[k], jr[k], what=f"obs step {t} {k}")
            jr, jc = apply(params, jc, jnp.asarray(act[:, t]), method=JaxUniZero.infer_action_step)
            pr, pc = port.infer_action_step(pc, torch.from_numpy(act[:, t]))
            for k in jr:
                close(pr[k], jr[k], what=f"action step {t} {k}")
    assert int(pc.next_pos[0]) == 2 * K > port.max_tokens  # the ring wrapped
    close(pc.k, jc.k, what="cache k")
    close(pc.v, jc.v, what="cache v")
    np.testing.assert_array_equal(pc.pos.numpy(), np.asarray(jc.pos))
    np.testing.assert_array_equal(pc.next_pos.numpy(), np.asarray(jc.next_pos))


def test_moe_keeps_every_expert_that_ties_the_kth_logit():
    D, E = 16, 3
    x = np.random.default_rng(4).standard_normal((5, 7, D)).astype(np.float32)
    layer = jax_moe.MoELayer(D, num_experts=E, num_experts_per_tok=1)
    params = perturb(layer.init(jax.random.PRNGKey(0), jnp.asarray(x)), 4)
    kernel = params["params"]["gate"]["kernel"]
    kernel[:, 1] = kernel[:, 0]  # experts 0 and 1 always tie
    exp = layer.apply(params, jnp.asarray(x))
    port = moe.MoELayer(D, E, 1)
    port.load_state_dict({k.split("moe.", 1)[1]: v for k, v in flax_to_state_dict(
        {"_wm": {"Block_0": {"MoELayer_0": params["params"]}}}).items()})
    with torch.no_grad():
        got = port(torch.from_numpy(x))
        w = moe.gate_weights(port.gate(torch.from_numpy(x)), 1)
    close(got, exp)
    two = (w > 0).sum(-1) == 2
    assert bool(two.any()), "no token had tied top gates"
    # torch.topk would keep one expert per token
    assert not torch.equal(w > 0, torch.nn.functional.one_hot(w.argmax(-1), E).bool())


@pytest.mark.parametrize("stage", [0, 1, 2])
def test_curriculum_lora_matches_flax_with_its_trainable_mask(stage):
    jm, params, port = make_models(seed=5, lora_r=2, curriculum_stage_num=3,
                                   curriculum_stage=stage, num_tasks=2)
    _check_train_forward(jm, params, port, *_obs_actions(5, 2, 3, (4,)))
    exp_mask = flat(jax_tf.curriculum_trainable_mask(params, stage))
    exp_mask = {_unizero_port_name(k.split("/", 1)[1]): bool(v) for k, v in exp_mask.items()}
    got_mask = transformer.curriculum_trainable_mask(
        [n for n, _ in port.named_parameters()], stage)
    assert got_mask == exp_mask
    assert any(v for k, v in got_mask.items() if "lora_A" in k) == (stage > 0)


def test_vit_encoder_matches_flax():
    shape = (16, 16, 3)
    jm, params, port = make_models(seed=6, observation_shape=shape, obs_type="image",
                                   encoder_type="vit", continuous_action=True,
                                   action_space_size=1, latent_norm="LayerNorm")
    obs = np.random.default_rng(6).standard_normal((3,) + shape).astype(np.float32)
    vit_params = {"params": params["params"]["_enc_vit"]}
    exp = JaxViT(out_dim=32).apply(vit_params, jnp.asarray(obs))
    with torch.no_grad():
        close(port.encoder_vit(torch.from_numpy(obs)), exp)
    _check_train_forward(jm, params, port, *_obs_actions(6, 2, 2, shape, A=1, continuous=True))


@pytest.mark.parametrize("kind", ["vector", "conv_downsample", "conv_flat"])
def test_decoders_match_flax(kind):
    extra = dict(with_decoder=True)
    if kind != "vector":
        shape = (16, 16, 3) if kind == "conv_downsample" else (10, 10, 4)
        extra.update(observation_shape=shape, obs_type="image", num_channels=8,
                     downsample=kind == "conv_downsample", action_space_size=3)
    jm, params, port = make_models(seed=7, **extra)
    emb = np.random.default_rng(7).standard_normal((3, 32)).astype(np.float32)
    exp = jm.apply(params, jnp.asarray(emb), method=JaxUniZero.decode_obs)
    with torch.no_grad():
        got = port.decode_obs(torch.from_numpy(emb))
    assert got.shape == exp.shape
    close(got, exp)


@pytest.mark.parametrize("size", [(2, 2), (3, 5)])
def test_conv_transpose_follows_the_flax_rule(size):
    x = np.random.default_rng(8).standard_normal((2,) + size + (3,)).astype(np.float32)
    layer = fnn.ConvTranspose(4, (3, 3), strides=(2, 2))
    params = perturb(layer.init(jax.random.PRNGKey(0), jnp.asarray(x)), 8)
    port = ConvTransposeNHWC(3, 4)
    port.load_state_dict({"weight": torch.from_numpy(
        np.ascontiguousarray(params["params"]["kernel"].transpose(3, 2, 0, 1))),
        "bias": torch.from_numpy(params["params"]["bias"])})
    exp = layer.apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.shape == exp.shape == (2, 2 * size[0], 2 * size[1], 4)
    close(got, exp)


BRANCHES = {
    "vector_lora_tasks_decoder": dict(with_decoder=True, lora_r=2, curriculum_stage_num=2,
                                      num_tasks=3),
    "conv_moe_decoder": dict(observation_shape=(16, 16, 3), obs_type="image", num_channels=8,
                             downsample=True, with_decoder=True, moe_in_transformer=True,
                             num_experts=3, action_space_size=3),
    "vit_continuous_layernorm": dict(observation_shape=(16, 16, 3), obs_type="image",
                                     encoder_type="vit", continuous_action=True,
                                     action_space_size=2, latent_norm="LayerNorm"),
}


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_import_is_exact_both_ways(branch):
    jm, params, port = make_models(seed=9, **BRANCHES[branch])
    assert set(port.state_dict()) == set(flax_to_state_dict(params))
    back, exp = flat(state_dict_to_flax(port.state_dict())), flat(params)
    assert set(back) == set(exp)
    for k in exp:
        assert back[k].shape == exp[k].shape, k
        np.testing.assert_array_equal(back[k], exp[k], err_msg=k)


def test_import_refuses_unknown_parameters():
    _, params, _ = make_models()
    bad = dict(params["params"], _mystery={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match="_mystery"):
        flax_to_state_dict({"params": bad})


def _prefill_inputs(seed, B, H):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H + 1, 4)).astype(np.float32), rng.integers(0, 2, (B, H)))


def test_prefill_at_full_history_matches_flax_and_the_token_by_token_path():
    jm, params, port = make_models(seed=10)
    B, H = 3, 4
    obs, act = _prefill_inputs(10, B, H)
    length = np.full(B, H)
    exp, jcache = jm.apply(params, jnp.asarray(obs), jnp.asarray(act), jnp.asarray(length),
                           method=JaxUniZero.prefill)
    with torch.no_grad():
        got, cache = port.prefill(torch.from_numpy(obs), torch.from_numpy(act),
                                  torch.from_numpy(length))
        seq = port.init_cache(B)
        for t in range(H + 1):
            o_out, seq = port.infer_obs_step(seq, port.encode_obs(torch.from_numpy(obs[:, t])))
            if t < H:
                _, seq = port.infer_action_step(seq, torch.from_numpy(act[:, t]))
    for k in exp:
        close(got[k], exp[k], what=k)
        close(got[k], o_out[k], what=f"token by token {k}")
    close(cache.k, jcache.k)
    np.testing.assert_array_equal(cache.pos.numpy(), np.asarray(jcache.pos))
    np.testing.assert_array_equal(cache.next_pos.numpy(), 2 * H + 1)


def test_prefill_of_a_short_history_is_jax_prefill_of_the_cut_history():
    """The guard of the JAX prefill fault (ROADMAP queue 3): rows with
    hist_len < H are NaN in JAX (2 layers); the port gives each row what
    JAX gives for that row's history cut to its own length."""
    jm, params, port = make_models(seed=11)
    H = 4
    lengths = np.array([0, 2, 4])
    obs, act = _prefill_inputs(11, 3, H)
    exp, _ = jm.apply(params, jnp.asarray(obs), jnp.asarray(act), jnp.asarray(lengths),
                      method=JaxUniZero.prefill)
    jax_finite = np.isfinite(np.asarray(exp["value_logits"])).all(-1)
    assert jax_finite.tolist() == [False, False, True]
    with torch.no_grad():
        got, cache = port.prefill(torch.from_numpy(obs), torch.from_numpy(act),
                                  torch.from_numpy(lengths))
    assert all(bool(torch.isfinite(v).all()) for v in got.values())
    for row, n in enumerate(lengths):
        cut, jc = jm.apply(params, jnp.asarray(obs[row:row + 1, H - n:]),
                           jnp.asarray(act[row:row + 1, H - n:]), jnp.asarray([n]),
                           method=JaxUniZero.prefill)
        for k in cut:
            close(got[k][row:row + 1], cut[k], what=f"row {row} {k}")
        np.testing.assert_array_equal(cache.pos[row:row + 1].numpy(), np.asarray(jc.pos))
        close(cache.k[row:row + 1], jc.k, what=f"row {row} cache")


def test_a_ring_write_longer_than_the_ring_keeps_the_latest_tokens():
    cfg = transformer.TransformerConfig(num_layers=1, num_heads=1, embed_dim=2, max_tokens=3)
    cache = transformer.init_kv_cache(cfg, 2)
    pos = torch.tensor([[-1, 0, 1, 2, 3, 4], [0, 1, 2, 3, 4, 5]])
    new = pos.to(torch.float32)[:, None, None, :, None].expand(2, 1, 1, 6, 2)
    out = transformer.write_ring(cache, new, -new, pos)
    assert out.pos.tolist() == [[3, 4, 2], [3, 4, 5]]
    assert out.k[:, 0, 0, :, 0].tolist() == [[3.0, 4.0, 2.0], [3.0, 4.0, 5.0]]
    assert out.v[:, 0, 0, :, 0].tolist() == [[-3.0, -4.0, -2.0], [-3.0, -4.0, -5.0]]
    assert out.next_pos.tolist() == [5, 6]


WS2_CKPT = "data_uz/breakout_grid_unizero_ws2_seed0/ckpt/params_best"


def test_committed_ws2_params_give_flax_inference_in_the_port():
    """The Grid Breakout UniZero params of the committed ws2 run (conv 64,
    embed 256, 2 layers, 8 heads, 24 tokens) load into the port through the
    importer, exactly both ways, and its train forward and token-by-token
    inference equal flax's on observations of the port's env, to 1e-4 (the
    heads read 256-wide LayerNorms of sums over 2 layers and 6,400-wide
    projections)."""
    import json
    import pathlib

    from lightzero_tpu.utils.checkpoint import load_checkpoint
    from lightzero_tpu_torch.envs import BreakoutGridEnv

    root = pathlib.Path(__file__).resolve().parent.parent
    restored = load_checkpoint(str(root / WS2_CKPT))
    params = {"params": jax.tree_util.tree_map(np.asarray, restored["params"]["params"])}
    total = json.loads((root / WS2_CKPT).parent.parent.joinpath("total_config.json").read_text())
    cfg = dict(total["policy"]["model"], value_support_size=101, reward_support_size=101)
    cfg["observation_shape"] = tuple(cfg["observation_shape"])
    from lightzero_tpu.config import Config as JaxConfig
    from lightzero_tpu_torch.config import Config

    jm = JaxUniZero.from_config(JaxConfig(cfg))
    port = UniZeroModel.from_config(Config(cfg)).eval()
    port.load_state_dict(flax_to_state_dict(params))
    back, exp = flat(state_dict_to_flax(port.state_dict())), flat(params)
    assert set(back) == set(exp)
    assert all(back[k].shape == exp[k].shape and np.array_equal(back[k], exp[k]) for k in exp)

    env = BreakoutGridEnv()
    g = torch.Generator().manual_seed(0)
    state, obs = env.reset(2, g)
    frames, actions = [obs], []
    for _ in range(3):
        a = torch.randint(0, 3, (2,), generator=g)
        step = env.step(state, a, g)
        state = step.state
        frames.append(step.obs)
        actions.append(a)
    obs_seq = torch.stack(frames, 1).numpy()
    act = torch.stack(actions, 1).numpy()
    exp_out = jm.apply(params, jnp.asarray(obs_seq), jnp.asarray(act),
                       method=JaxUniZero.train_forward)
    with torch.no_grad():
        got = port.train_forward(torch.from_numpy(obs_seq), torch.from_numpy(act))
    for k in exp_out:
        close(got[k], exp_out[k], tol=1e-4, what=k)
    jc = jm.apply(params, 2, method=JaxUniZero.init_cache)
    je = jm.apply(params, jnp.asarray(obs_seq[:, 0]), method=JaxUniZero.encode_obs)
    jr, jc = jm.apply(params, jc, je, method=JaxUniZero.infer_obs_step)
    ja, _ = jm.apply(params, jc, jnp.asarray(act[:, 0]), method=JaxUniZero.infer_action_step)
    with torch.no_grad():
        pr, pc = port.infer_obs_step(port.init_cache(2), port.encode_obs(torch.from_numpy(obs_seq[:, 0])))
        pa, _ = port.infer_action_step(pc, torch.from_numpy(act[:, 0]))
    for k in jr:
        close(pr[k], jr[k], tol=1e-4, what=k)
    for k in ja:
        close(pa[k], ja[k], tol=1e-4, what=k)
