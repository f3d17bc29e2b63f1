"""Port vs JAX: the visualisation module (lightzero_tpu_torch/models/visualize.py),
the transformer's attention capture (models/unizero_world_model/transformer.py,
``capture_attention``) and the text encoders (models/text_encoders.py).

- The three PNG writers give the bytes the JAX module's give on the same
  arrays.
- ``capture_attention`` around a full-sequence forward of the small UniZero
  model of tests/test_torch_unizero_model.py (2 layers, 4 heads) gives, layer
  by layer, the attention that flax's ``sow`` puts in "intermediates", to
  1e-5; off, it keeps nothing; searches (the KV-cache path) add nothing.
- ``HFLanguageEncoder.tiny_random`` built from the same torch seed on both
  sides embeds texts to equal arrays, with either pooling; ``available()``
  is False on both for weights that are not on this machine.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightzero_tpu.models import text_encoders as jax_text
from lightzero_tpu.models import visualize as jax_vis
from lightzero_tpu.models.unizero import UniZeroModel as JaxUniZero
from lightzero_tpu_torch.models import UniZeroModel, text_encoders, visualize
from lightzero_tpu_torch.models.unizero_world_model.transformer import capture_attention
from lightzero_tpu_torch.utils.params_import import flax_to_state_dict
from test_torch_unizero_model import SMALL, _obs_actions, close, perturb, port_kwargs

pytestmark = pytest.mark.unittest


def png_bytes(path):
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    return data


def test_pngs_equal_the_jax_module_s(tmp_path):
    rng = np.random.default_rng(0)
    frames = rng.uniform(0, 1, (4, 10, 10, 4))
    recon = rng.uniform(0, 1, (4, 10, 10, 4))
    att = [rng.dirichlet(np.ones(6), (2, 3, 6)), rng.dirichlet(np.ones(6), (3, 6))]
    emb = rng.standard_normal((20, 8))
    calls = [
        ("recon.png", lambda m, p: m.visualize_reconstruction(
            frames, recon, p, rewards=np.arange(4.0), values=np.ones(4))),
        ("attention.png", lambda m, p: m.visualize_attention_maps(att, p)),
        ("latent.png", lambda m, p: m.plot_latent_map(emb, p)),
    ]
    for name, call in calls:
        got = call(visualize, str(tmp_path / "port" / name))
        exp = call(jax_vis, str(tmp_path / "jax" / name))
        assert png_bytes(got) == png_bytes(exp), name


def test_attention_capture_matches_flax_sow():
    jm = JaxUniZero(**SMALL)
    params = perturb(jax.jit(jm.init_params)(jax.random.PRNGKey(3)), 3)
    port = UniZeroModel(**port_kwargs(SMALL)).eval()
    port.load_state_dict(flax_to_state_dict(params))
    obs, act = _obs_actions(3, 2, 3, (4,))
    _, state = jax.jit(functools.partial(jm.apply, method=JaxUniZero.train_forward,
                                         mutable=["intermediates"]))(
        params, jnp.asarray(obs), jnp.asarray(act))
    sown = [v for path, v in jax.tree_util.tree_leaves_with_path(state["intermediates"])
            if "attention" in jax.tree_util.keystr(path)]
    assert len(sown) == 2
    with torch.no_grad(), capture_attention(port) as maps:
        port.train_forward(torch.from_numpy(obs), torch.from_numpy(act))
    assert len(maps) == 2
    for got, exp in zip(maps, sown):
        assert got.shape == exp.shape == (2, 4, 7, 7)  # 4 obs and 3 action tokens
        close(got, exp)
    # off again: nothing more is kept
    with torch.no_grad():
        port.train_forward(torch.from_numpy(obs), torch.from_numpy(act))
    assert len(maps) == 2
    assert all(m.captured is None for m in port.modules() if hasattr(m, "captured"))


def test_attention_capture_skips_the_cache_path():
    from lightzero_tpu_torch.policy import UniZeroPolicy

    policy = UniZeroPolicy(dict(model=dict(embed_dim=16, num_heads=2), num_simulations=2),
                           device="cpu")
    with capture_attention(policy.model) as maps:
        policy.forward_eval(torch.zeros(2, 4), torch.ones(2, 2, dtype=torch.bool))
    assert maps == []


def encoder_pair(pooling):
    torch.manual_seed(0)
    jax_side = jax_text.HFLanguageEncoder.tiny_random(pooling=pooling)
    torch.manual_seed(0)
    port = text_encoders.HFLanguageEncoder.tiny_random(pooling=pooling)
    return jax_side, port


@pytest.mark.parametrize("pooling", ["cls", "mean"])
def test_tiny_random_encoder_equals_jax_s(pooling):
    pytest.importorskip("transformers")
    jax_side, port = encoder_pair(pooling)
    texts = ["you are in a dark room", "open the door", "north"]
    got, exp = port.encode(texts), jax_side.encode(texts)
    assert got.shape == (3, 32) and got.dtype == np.float32
    np.testing.assert_array_equal(got, exp)
    assert port.hidden_size == jax_side.hidden_size == 32


def test_encoders_gate_on_local_weights():
    pytest.importorskip("transformers")
    name = "no-such-org/no-such-model"
    assert text_encoders.HFLanguageEncoder.available(name) is False
    assert jax_text.HFLanguageEncoder.available(name) is False
    with pytest.raises(OSError):
        text_encoders.HFLanguageEncoder(name)
