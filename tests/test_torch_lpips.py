"""Port vs JAX: LPIPS (lightzero_tpu_torch/ops/lpips.py against
lightzero_tpu/ops/lpips.py) and UniZero's perceptual term
(lightzero_tpu_torch/policy/unizero.py against lightzero_tpu/policy/unizero.py).

- The trunk's kernels and the heads' weights are bit-equal to JAX's, both
  the random trunk drawn from np.random.default_rng(0) and one read from a
  ``$LZT_LPIPS_WEIGHTS`` file that holds some of the keys.
- Distances to 1e-5 relative on numpy-seeded images in [0, 1]: 10x10 (the
  trunk stops before its fourth pool, four heads), 16x16 and 32x32, with
  1, 3 and 4 channels.
- The trunk is frozen: no parameter, no state-dict entry, nothing in the
  UniZero policy's model or optimizer.
- Learn steps of a small image UniZero (10x10x4 frames, conv 4 channels,
  embed 16, 1 layer, 2 heads, batch 4, unroll 2) with the reconstruction
  loss (weight 1) and the perceptual term (weight 2) against the jitted JAX
  learn step from the same params, at tests/test_torch_unizero_policy.py's
  tolerances: the logged terms 1e-5 relative (1e-6 floor), priorities 1e-5, params under
  its Adam-scale criterion.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightzero_tpu.config.core import deep_merge as jax_deep_merge
from lightzero_tpu.ops import lpips as jax_lpips
from lightzero_tpu.policy.muzero import TrainBatch as JaxTrainBatch
from lightzero_tpu.policy.muzero import TrainState as JaxTrainState
from lightzero_tpu.policy.unizero import UniZeroPolicy as JaxUniZeroPolicy
from lightzero_tpu_torch.ops.lpips import LPIPS, lpips_distance, lpips_params
from lightzero_tpu_torch.policy import UniZeroPolicy
from lightzero_tpu_torch.policy.muzero import TrainBatch
from lightzero_tpu_torch.utils.params_import import flax_to_state_dict
from test_torch_unizero_policy import (
    LOG_RTOL,
    adam_scale_seen,
    assert_params_close,
    check_logs,
    perturb,
)

pytestmark = pytest.mark.unittest

DIST_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_random_trunk_is_bit_equal_to_jax():
    exp, got = jax_lpips._params(), lpips_params()
    assert set(got) == set(exp) and len(got) == 13 + 5
    for k in exp:
        np.testing.assert_array_equal(got[k], exp[k], err_msg=k)
    # the module holds them as OIHW conv weights
    m = LPIPS("cpu")
    np.testing.assert_array_equal(m.conv3_2.permute(2, 3, 1, 0).numpy(), exp["conv3_2"])


def test_weights_file_is_read_as_jax_reads_it(tmp_path, monkeypatch):
    rng = np.random.default_rng(5)
    path = tmp_path / "lpips.npz"
    np.savez(path, **{"conv1_1/kernel": rng.standard_normal((3, 3, 3, 64)),
                      "lin2": -rng.uniform(size=(1, 256, 1, 1))})
    monkeypatch.setenv("LZT_LPIPS_WEIGHTS", str(path))
    jax_lpips._params.cache_clear()
    lpips_params.cache_clear()
    try:
        exp = jax_lpips._params()
        got = lpips_params()
    finally:
        jax_lpips._params.cache_clear()
        lpips_params.cache_clear()
    for k in exp:
        np.testing.assert_array_equal(got[k], exp[k], err_msg=k)
    assert (got["lin2"] > 0).all() and got["lin0"][0] == np.float32(1 / 64)


@pytest.mark.parametrize("hw,channels", [(10, 4), (10, 1), (16, 3), (32, 1), (32, 4)])
def test_distance_matches_jax(hw, channels):
    rng = np.random.default_rng(hw * 10 + channels)
    x = rng.uniform(0, 1, (3, hw, hw, channels)).astype(np.float32)
    y = rng.uniform(0, 1, (3, hw, hw, channels)).astype(np.float32)
    exp = np.asarray(jax_lpips.lpips_distance(jnp.asarray(x), jnp.asarray(y)))
    got = lpips_distance(torch.from_numpy(x), torch.from_numpy(y))
    assert got.shape == (3,) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), exp, rtol=DIST_RTOL, atol=0)
    # the same image is at distance 0
    assert float(lpips_distance(torch.from_numpy(x), torch.from_numpy(x)).abs().max()) == 0.0


def test_small_input_stops_before_the_fourth_pool():
    m = LPIPS("cpu")
    feats = m.features(torch.zeros(1, 3, 10, 10))
    assert [f.shape[-1] for f in feats] == [10, 5, 2, 1]


SMALL_IMAGE = dict(
    model=dict(observation_shape=(10, 10, 4), obs_type="image", action_space_size=3,
               embed_dim=16, num_layers=1, num_heads=2, max_tokens=8, support_scale=10,
               num_channels=4, downsample=False),
    num_simulations=2, num_unroll_steps=2, batch_size=4, learning_rate=1e-3,
    latent_recon_loss_weight=1.0, perceptual_loss_weight=2.0,
    use_encoder_clip_annealing=False, use_head_clip=False,
)


def image_batch(seed, B=4, K=2, A=3):
    rng = np.random.default_rng(seed)
    steps_left = rng.integers(0, K + 1, B)
    return dict(
        obs=rng.uniform(0, 1, (B, K + 1, 10, 10, 4)).astype(np.float32),
        actions=rng.integers(0, A, (B, K)).astype(np.int64),
        mask=(np.arange(K)[None] < steps_left[:, None]).astype(np.float32),
        target_reward=rng.uniform(-2, 2, (B, K)).astype(np.float32),
        target_value=rng.uniform(-5, 5, (B, K + 1)).astype(np.float32),
        target_policy=rng.dirichlet(np.ones(A), (B, K + 1)).astype(np.float32),
        weights=rng.uniform(0.2, 1.0, B).astype(np.float32),
    )


def test_trunk_is_in_no_state_dict_and_no_optimizer():
    policy = UniZeroPolicy(SMALL_IMAGE, device="cpu")
    assert isinstance(policy.lpips, LPIPS) and policy.lpips.state_dict() == {}
    assert not list(policy.lpips.parameters())
    trunk = {id(b) for b in policy.lpips.buffers()}
    state = policy.init_train_state()
    in_optimizer = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
    assert not trunk & in_optimizer
    assert not any("lpips" in k or "conv1_1" in k for k in policy.model.state_dict())
    # without the reconstruction loss the term never runs, and no trunk is built
    assert UniZeroPolicy(dict(SMALL_IMAGE, latent_recon_loss_weight=0.0), device="cpu").lpips is None


def test_learn_steps_with_the_perceptual_term_match_jax():
    cfg = jax_deep_merge(JaxUniZeroPolicy.default_config(), SMALL_IMAGE)
    jax_policy = JaxUniZeroPolicy(cfg)
    # each under one jit: eager flax and optax inits compile op by op
    params = perturb(jax.jit(jax_policy.model.init_params)(jax.random.PRNGKey(3)), 3)
    port = UniZeroPolicy(SMALL_IMAGE, device="cpu")
    port.model.load_state_dict(flax_to_state_dict(params))
    jax_state = JaxTrainState(params=jax.tree_util.tree_map(jnp.asarray, params),
                              target_params=jax.tree_util.tree_map(jnp.asarray, params),
                              opt_state=jax.jit(jax_policy.optimizer.init)(params),
                              train_iter=jnp.zeros((), jnp.int32))
    state = port.init_train_state()
    grad_fn = jax.jit(jax.grad(lambda p, b, it: jax_policy._loss_fn(p, b, it)[0]))
    seen = None
    for step in range(2):
        b = image_batch(30 + step)
        jb = JaxTrainBatch(**{k: jnp.asarray(v.astype(np.int32) if k == "actions" else v)
                              for k, v in b.items()})
        seen, held = adam_scale_seen(jax_policy, jax_state.params, jb, step, seen, grad_fn)
        jax_state, jax_logs, jax_prio = jax_policy.forward_learn(jax_state, jb)
        state, logs, prio = port.forward_learn(
            state, TrainBatch(**{k: torch.from_numpy(v) for k, v in b.items()}))
        check_logs(logs, jax_logs)
        # the perceptual term moves the logged reconstruction loss well
        # beyond the MSE of images in [0, 1]
        assert float(jax_logs["latent_recon_loss"]) > 0.01
        np.testing.assert_allclose(prio.numpy(), np.asarray(jax_prio), rtol=LOG_RTOL, atol=1e-5)
        assert_params_close(port.model, jax_state.params, held, lr=1e-3)


def test_recon_loss_holds_the_perceptual_term_as_jax_weighs_it():
    """The reconstruction log is MSE + (pw / recon_w) mean LPIPS, on the
    (B K1, H, W, C) frames clipped to [0, 1]."""
    weights = dict(latent_recon_loss_weight=0.1, perceptual_loss_weight=0.5)
    port = UniZeroPolicy(dict(SMALL_IMAGE, **weights), device="cpu")
    plain = UniZeroPolicy(dict(SMALL_IMAGE, **dict(weights, perceptual_loss_weight=0.0)),
                          device="cpu")
    plain.model.load_state_dict(port.model.state_dict())
    b = TrainBatch(**{k: torch.from_numpy(v) for k, v in image_batch(40).items()})
    with torch.no_grad():
        _, (logs, _) = port._loss_fn(port.model, b)
        _, (plain_logs, _) = plain._loss_fn(plain.model, b)
        out = port.model.train_forward(b.obs, b.actions)
        recon = port.model.decode_obs(out["obs_embeddings"].reshape(12, -1))
        frames = b.obs.reshape(12, 10, 10, 4)
        lp = lpips_distance(recon.clamp(0, 1), frames.clamp(0, 1)).mean()
    np.testing.assert_allclose(float(logs["latent_recon_loss"]),
                               float(plain_logs["latent_recon_loss"]) + 0.5 / 0.1 * float(lp),
                               rtol=1e-6)


def test_lpips_without_device_raises_with_no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LPIPS()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        UniZeroPolicy(SMALL_IMAGE)
