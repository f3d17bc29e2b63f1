"""Port vs JAX: the loss landscape (lightzero_tpu_torch/loss_landscape/
against lightzero_tpu/loss_landscape/) and its entry
(train_muzero's post-training phase, train_unizero_with_loss_landscape).

- ``loss_landscape_api`` in 1-D and 2-D on MuZero (tests/test_torch_learn.py's
  small MLP model, perturbed params, a numpy-seeded batch) and in 1-D on
  UniZero, on JAX's directions (drawn by the JAX ``random_direction`` from
  the split key and carried across with utils/params_import.py): the same
  .npz names and keys, the grid equal, the surface 1e-5 relative; the
  model's parameters and buffers bit-unchanged.
- ``random_direction``'s filter norm: each tensor at its parameter's norm,
  at least 1e-2 (zero-initialised tensors).
- ``pca_directions`` and ``project_trajectory`` on the same checkpoints:
  explained variance 1e-9 relative, the directions and the projections
  equal up to each direction's sign, 1e-9.
- The rendered PNGs, and the VTK file equal to JAX's text.
- ``train_unizero_with_loss_landscape`` on a tiny CartPole UniZero on the
  CPU writes ``loss_landscape/loss_surface_1d.npz`` (11 finite points) and
  its PNG; the alias sets the flag as the JAX one does.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightzero_tpu import loss_landscape as jax_ll
from lightzero_tpu.config.core import deep_merge as jax_deep_merge
from lightzero_tpu.policy.muzero import MuZeroPolicy as JaxMuZeroPolicy
from lightzero_tpu.policy.unizero import UniZeroPolicy as JaxUniZeroPolicy
from lightzero_tpu_torch import entry
from lightzero_tpu_torch import loss_landscape as ll
from lightzero_tpu_torch.policy import MuZeroPolicy, UniZeroPolicy
from lightzero_tpu_torch.utils.params_import import flax_to_state_dict
from test_torch_learn import SMALL, as_jax_batch, as_port_batch, random_batch
from test_torch_model import perturbed_params
from test_torch_unizero_policy import SMALL as UZ_SMALL
from test_torch_unizero_policy import as_jax as uz_as_jax
from test_torch_unizero_policy import as_port as uz_as_port
from test_torch_unizero_policy import perturb
from test_torch_unizero_policy import random_batch as uz_random_batch

pytestmark = pytest.mark.unittest

SURFACE_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def muzero_pair(seed=0):
    jax_policy = JaxMuZeroPolicy(jax_deep_merge(JaxMuZeroPolicy.default_config(), SMALL))
    params = perturbed_params(jax_policy.model, seed)
    port = MuZeroPolicy(SMALL, device="cpu")
    port.model.load_state_dict(flax_to_state_dict(params))
    return jax_policy, jax.tree_util.tree_map(jnp.asarray, params), port


def jax_directions(params, key):
    r1, r2 = jax.random.split(key)
    return jax_ll.random_direction(params, r1), jax_ll.random_direction(params, r2)


def as_port_direction(d):
    return flax_to_state_dict(jax.tree_util.tree_map(np.asarray, d))


def snapshot(model):
    return {k: v.clone() for k, v in model.state_dict().items()}


def assert_unchanged(model, before):
    after = model.state_dict()
    assert after.keys() == before.keys()
    assert all(torch.equal(after[k], v) for k, v in before.items())


@pytest.mark.parametrize("mode", ["1d", "2d"])
def test_muzero_surface_matches_jax(tmp_path, mode):
    jax_policy, params, port = muzero_pair()
    b = random_batch(7)
    steps = 5 if mode == "1d" else 3
    key = jax.random.PRNGKey(11)
    exp = jax_ll.loss_landscape_api(jax_policy, params, as_jax_batch(b), str(tmp_path / "jax"),
                                    mode=mode, span=0.5, steps=steps, rng=key, render=False)
    d1, d2 = jax_directions(params, key)
    before = snapshot(port.model)
    got = ll.loss_landscape_api(port, port.model, as_port_batch(b), str(tmp_path / "port"),
                                mode=mode, span=0.5, steps=steps, render=False,
                                directions=(as_port_direction(d1), as_port_direction(d2)))
    assert_unchanged(port.model, before)
    name = f"loss_surface_{mode}.npz"
    saved, jax_saved = np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name)
    assert sorted(saved.files) == sorted(jax_saved.files) and sorted(got) == sorted(exp)
    np.testing.assert_array_equal(saved["alphas"], jax_saved["alphas"])
    np.testing.assert_allclose(saved["loss"], jax_saved["loss"], rtol=SURFACE_RTOL)
    np.testing.assert_allclose(got["loss"], exp["loss"], rtol=SURFACE_RTOL)
    # the surface moves: the directions are not zero
    assert np.ptp(got["loss"]) > 1e-3


def test_unizero_surface_matches_jax(tmp_path):
    jax_policy = JaxUniZeroPolicy(jax_deep_merge(JaxUniZeroPolicy.default_config(), UZ_SMALL))
    params = perturb(jax.jit(jax_policy.model.init_params)(jax.random.PRNGKey(4)), 4)
    port = UniZeroPolicy(UZ_SMALL, device="cpu")
    port.model.load_state_dict(flax_to_state_dict(params))
    params = jax.tree_util.tree_map(jnp.asarray, params)
    b = uz_random_batch(8)
    key = jax.random.PRNGKey(12)
    exp = jax_ll.loss_landscape_api(jax_policy, params, uz_as_jax(b), str(tmp_path / "jax"),
                                    mode="1d", span=1.0, steps=5, rng=key, render=False)
    d1, d2 = jax_directions(params, key)
    before = snapshot(port.model)
    got = ll.loss_landscape_api(port, port.model, uz_as_port(b), str(tmp_path / "port"),
                                mode="1d", span=1.0, steps=5, render=False,
                                directions=(as_port_direction(d1), as_port_direction(d2)))
    assert_unchanged(port.model, before)
    np.testing.assert_allclose(got["loss"], exp["loss"], rtol=SURFACE_RTOL)


def test_random_direction_keeps_the_filter_norm():
    _, _, port = muzero_pair()
    with torch.no_grad():
        next(iter(port.model.parameters())).zero_()
    g = torch.Generator().manual_seed(0)
    d = ll.random_direction(port.model, g)
    named = dict(port.model.named_parameters())
    assert d.keys() == named.keys()
    for k, v in d.items():
        norm = max(float(torch.linalg.vector_norm(named[k].detach())), 1e-2)
        np.testing.assert_allclose(float(torch.linalg.vector_norm(v)), norm, rtol=1e-5)
    layer = ll.random_direction(port.model, g, norm="layer")
    assert all(abs(float(torch.linalg.vector_norm(v)) - 1.0) < 1e-5 for v in layer.values())
    # the same generator state draws the same direction
    again = ll.random_direction(port.model, torch.Generator().manual_seed(0))
    assert all(torch.equal(again[k], d[k]) for k in d)


def test_pca_directions_and_trajectory_match_jax():
    jax_policy, params, port = muzero_pair(1)
    rng = np.random.default_rng(3)
    ckpts = [jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.01 * (i + 1) * rng.standard_normal(np.shape(x)).astype(np.float32),
        params) for i in range(4)]
    port_ckpts = [flax_to_state_dict(c) for c in ckpts]
    d1, d2, var = ll.pca_directions(port_ckpts, port.model)
    j1, j2, jvar = jax_ll.pca_directions(ckpts, params)
    np.testing.assert_allclose(var, jvar, rtol=1e-9)
    traj = ll.project_trajectory(port_ckpts, port.model, d1, d2)
    jtraj = jax_ll.project_trajectory(ckpts, params, j1, j2)
    assert traj.shape == (4, 2)
    for col in range(2):
        sign = np.sign(traj[0, col] * jtraj[0, col])
        np.testing.assert_allclose(traj[:, col], sign * jtraj[:, col], rtol=1e-9, atol=1e-12)
    # the directions themselves, element for element through the importer
    for got, exp in ((d1, j1), (d2, j2)):
        p_dir = ll.unflatten_like(got, port.model)
        j_dir = flax_to_state_dict(jax.tree_util.tree_map(
            np.asarray, jax_ll.unflatten_like(exp, params)))
        k0 = next(iter(p_dir))
        sign = np.sign(float(p_dir[k0].flatten()[0]) * float(j_dir[k0].flatten()[0]))
        for k in p_dir:
            np.testing.assert_allclose(p_dir[k].numpy(), sign * j_dir[k].numpy(), rtol=1e-6,
                                       atol=1e-9, err_msg=k)


def test_rendering_writes_the_pngs_and_jax_s_vtk(tmp_path):
    rng = np.random.default_rng(0)
    alphas = np.linspace(-1, 1, 4)
    loss2 = rng.uniform(1, 3, (4, 4))
    for d in ("port", "jax"):
        (tmp_path / d).mkdir()
        np.savez(tmp_path / d / "loss_surface_1d.npz", alphas=alphas, loss=loss2[0])
        np.savez(tmp_path / d / "loss_surface_2d.npz", alphas=alphas, betas=alphas, loss=loss2)
    got = ll.render_landscape_dir(str(tmp_path / "port"), trajectory=np.zeros((2, 2)))
    exp = jax_ll.render_landscape_dir(str(tmp_path / "jax"), trajectory=np.zeros((2, 2)))
    assert [p.split("/")[-1] for p in got] == [p.split("/")[-1] for p in exp] == [
        "loss_surface_1d.png", "loss_surface_2d.png", "loss_surface_2d.vtk"]
    for p in got[:2]:
        with open(p, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    with open(got[2]) as f, open(exp[2]) as g:
        assert f.read() == g.read()


def tiny_unizero(exp_dir):
    from lightzero_tpu_torch.configs.cartpole_unizero import main_config

    cfg = copy.deepcopy(main_config)
    cfg.exp_name = str(exp_dir)
    cfg.env.update(collector_env_num=2, evaluator_env_num=2, n_evaluator_episode=2,
                   stop_value=1e9, max_episode_steps=16)
    cfg.policy.model.update(embed_dim=16, num_heads=2)
    cfg.policy.update(num_simulations=3, batch_size=8, update_per_collect=2, n_episode=2,
                      eval_freq=1000)
    return cfg


def test_train_unizero_with_loss_landscape_writes_the_surface(tmp_path):
    cfg = tiny_unizero(tmp_path / "exp")
    policy, state, stats = entry.train_unizero_with_loss_landscape(
        cfg, seed=0, max_train_iter=2, device="cpu")
    assert cfg.policy.analysis_loss_landscape is True  # set on the caller's config, as in JAX
    assert stats["train_iter"] == 2
    out = tmp_path / "exp" / "loss_landscape"
    saved = np.load(out / "loss_surface_1d.npz")
    assert sorted(saved.files) == ["alphas", "loss"]
    assert saved["loss"].shape == (11,) and np.isfinite(saved["loss"]).all()
    np.testing.assert_array_equal(saved["alphas"], np.linspace(-1, 1, 11))
    assert (out / "loss_surface_1d.png").exists()
