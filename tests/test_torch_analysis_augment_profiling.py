"""Port vs JAX: the augmentations (lightzero_tpu_torch/ops/augment.py), the
analysis metrics (models/analysis.py), profiling (utils/profiling.py) and
the logger's TensorBoard sink (utils/logger.py), against their JAX modules.

- ``random_shift``, ``intensity`` and ``augment_batch`` with JAX's draws
  injected (rebuilt from the same keys: one randint pair per image, one
  normal per image): the shift bit-equal, the gain 1e-7 relative.
- ``dormant_ratio`` equal; ``effective_rank`` 1e-5 relative (two SVDs);
  ``average_weight_magnitude`` of a model against the flax params, and
  ``latent_norm_stats``, 1e-6 relative.
- ``buffer_metrics`` of the port's buffer equal to JAX's on the same
  episodes; ``torch_trace`` writes a Chrome trace of the ops it saw (the
  spans: tests/test_torch_tracing.py).
- The logger writes TensorBoard scalar events under log/serial: a file
  version record, then one record a value with its tag, step and value,
  each record with its two checksums.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightzero_tpu.buffers.game_buffer import EpisodeRecord as JaxEpisodeRecord
from lightzero_tpu.buffers.game_buffer import GameBuffer as JaxGameBuffer
from lightzero_tpu.config.core import deep_merge as jax_deep_merge
from lightzero_tpu.models import analysis as jax_analysis
from lightzero_tpu.ops import augment as jax_augment
from lightzero_tpu.policy.muzero import MuZeroPolicy as JaxMuZeroPolicy
from lightzero_tpu.utils import profiling as jax_profiling
from lightzero_tpu_torch.buffers import EpisodeRecord, GameBuffer
from lightzero_tpu_torch.models import analysis
from lightzero_tpu_torch.ops import augment
from lightzero_tpu_torch.policy import MuZeroPolicy
from lightzero_tpu_torch.utils import profiling
from lightzero_tpu_torch.utils.logger import ExperimentLogger
from lightzero_tpu_torch.utils.params_import import flax_to_state_dict
from test_torch_buffer import random_episodes
from test_torch_learn import SMALL
from test_torch_model import perturbed_params

pytestmark = pytest.mark.unittest


def images(seed, B=5, H=10, W=8, C=3):
    return np.random.default_rng(seed).uniform(0, 1, (B, H, W, C)).astype(np.float32)


def jax_shift_draws(key, B, pad):
    return np.stack([np.asarray(jax.random.randint(r, (2,), 0, 2 * pad + 1))
                     for r in jax.random.split(key, B)])


@pytest.mark.parametrize("pad", [4, 2])
def test_random_shift_with_jax_draws_is_bit_equal(pad):
    x = images(pad)
    key = jax.random.PRNGKey(pad)
    exp = np.asarray(jax_augment.random_shift(key, jnp.asarray(x), pad))
    shifts = torch.from_numpy(jax_shift_draws(key, 5, pad))
    got = augment.random_shift(torch.from_numpy(x), pad, shifts=shifts)
    np.testing.assert_array_equal(got.numpy(), exp)


def test_intensity_and_augment_batch_with_jax_draws():
    x = images(1)
    key = jax.random.PRNGKey(3)
    noise = np.asarray(jax.random.normal(key, (5, 1, 1, 1))).reshape(5)
    exp = np.asarray(jax_augment.intensity(key, jnp.asarray(x), 0.2))
    got = augment.intensity(torch.from_numpy(x), 0.2, noise=torch.from_numpy(noise.copy()))
    np.testing.assert_allclose(got.numpy(), exp, rtol=1e-7)
    r1, r2 = jax.random.split(key)
    exp = np.asarray(jax_augment.augment_batch(key, jnp.asarray(x)))
    got = augment.augment_batch(
        torch.from_numpy(x), shifts=torch.from_numpy(jax_shift_draws(r1, 5, 4)),
        noise=torch.from_numpy(np.array(jax.random.normal(r2, (5, 1, 1, 1))).reshape(5)))
    np.testing.assert_allclose(got.numpy(), exp, rtol=1e-7)
    # without injected draws: the generator's, in range, reproducible
    a = augment.augment_batch(torch.from_numpy(x), generator=torch.Generator().manual_seed(0))
    b = augment.augment_batch(torch.from_numpy(x), generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and a.shape == x.shape


def test_analysis_metrics_match_jax():
    rng = np.random.default_rng(0)
    act = np.maximum(rng.standard_normal((64, 32)), 0).astype(np.float32)
    act[:, :5] *= 1e-3  # five dormant units
    assert float(analysis.dormant_ratio(torch.from_numpy(act))) == float(
        jax_analysis.dormant_ratio(jnp.asarray(act))) == 5 / 32
    feats = rng.standard_normal((40, 16)).astype(np.float32)
    feats[:, 8:] = 0.0  # rank 8
    np.testing.assert_allclose(float(analysis.effective_rank(torch.from_numpy(feats))),
                               float(jax_analysis.effective_rank(jnp.asarray(feats))), rtol=1e-5)
    latent = rng.standard_normal((6, 4, 3)).astype(np.float32)
    got = analysis.latent_norm_stats(torch.from_numpy(latent))
    exp = jax_analysis.latent_norm_stats(jnp.asarray(latent))
    assert got.keys() == exp.keys()
    for k in exp:
        np.testing.assert_allclose(float(got[k]), float(exp[k]), rtol=1e-6)
    jax_policy = JaxMuZeroPolicy(jax_deep_merge(JaxMuZeroPolicy.default_config(), SMALL))
    params = perturbed_params(jax_policy.model, 2)
    port = MuZeroPolicy(SMALL, device="cpu")
    port.model.load_state_dict(flax_to_state_dict(params))
    exp = float(jax_analysis.average_weight_magnitude(params))
    np.testing.assert_allclose(float(analysis.average_weight_magnitude(port.model)), exp, rtol=1e-6)
    np.testing.assert_allclose(float(analysis.average_weight_magnitude(
        dict(port.model.named_parameters()))), exp, rtol=1e-6)


def test_buffer_metrics_match_jax():
    episodes, priorities = random_episodes(5)
    port = GameBuffer(MuZeroPolicy(SMALL, device="cpu").cfg, None)
    jax_buf = JaxGameBuffer(jax_deep_merge(JaxMuZeroPolicy.default_config(), SMALL), None)
    port.push_episodes([EpisodeRecord(**e) for e in episodes], priorities)
    jax_buf.push_episodes([JaxEpisodeRecord(**e) for e in episodes], priorities)
    got, exp = profiling.buffer_metrics(port), jax_profiling.buffer_metrics(jax_buf)
    assert got == exp and got["pushed_transitions"] == got["transitions"] > 0


def test_torch_trace_writes_a_chrome_trace(tmp_path):
    with profiling.torch_trace(str(tmp_path / "profile")) as prof:
        torch.ones(8, 8) @ torch.ones(8, 8)
    with open(tmp_path / "profile" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def read_events(log_dir):
    """The events of the one events file in ``log_dir``, each record's two
    checksums checked (tensorboard's own readers import TensorFlow where it
    is installed)."""
    import glob
    import struct

    from tensorboard.compat.proto.event_pb2 import Event
    from tensorboard.compat.tensorflow_stub.pywrap_tensorflow import masked_crc32c

    (path,) = glob.glob(f"{log_dir}/events.out.tfevents.*")
    events = []
    with open(path, "rb") as f:
        while header := f.read(8):
            (n,) = struct.unpack("<Q", header)
            assert struct.unpack("<I", f.read(4))[0] == masked_crc32c(header)
            data = f.read(n)
            assert struct.unpack("<I", f.read(4))[0] == masked_crc32c(data)
            events.append(Event.FromString(data))
    return events


def test_logger_writes_tensorboard_scalars(tmp_path):
    log = ExperimentLogger(str(tmp_path / "exp"), "train")
    assert log.tb is not None
    log.log_scalars({"total_loss": torch.tensor(1.5), "lr": 0.01, "name": "skipped"}, 3,
                    prefix="learner/")
    log.log_scalars({"total_loss": 0.5}, 7, prefix="learner/")
    log.close()
    events = read_events(tmp_path / "exp" / "log" / "serial")
    assert events[0].file_version == "brain.Event:2"
    scalars = [(e.step, v.tag, v.simple_value) for e in events[1:] for v in e.summary.value]
    assert scalars == [(3, "learner/total_loss", 1.5), (3, "learner/lr", np.float32(0.01)),
                       (7, "learner/total_loss", 0.5)]
    # the JSON lines hold the same values
    with open(tmp_path / "exp" / "log" / "train.jsonl") as f:
        assert [json.loads(line)["learner/total_loss"] for line in f] == [1.5, 0.5]
    off = ExperimentLogger(str(tmp_path / "off"), "train", use_tb=False)
    assert off.tb is None
    off.close()
    assert not (tmp_path / "off" / "log" / "serial").exists()
