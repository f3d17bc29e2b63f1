"""Port vs JAX: value scaling and action selection
(lightzero_tpu_torch/ops against lightzero_tpu/ops) on the same numpy-seeded
inputs. Tolerance 1e-6 (relative and absolute): both sides compute in
float32 and differ only in the order of the 601-term softmax sums."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightzero_tpu.ops import scaling as jax_scaling
from lightzero_tpu.ops.action import sample_from_visit_counts as jax_sample
from lightzero_tpu_torch.ops import scaling
from lightzero_tpu_torch.ops.action import sample_from_visit_counts

pytestmark = pytest.mark.unittest

SUPPORTS = [(-300.0, 301.0, 1.0), (-10.0, 11.0, 1.0), (-5.0, 5.5, 0.5)]


@pytest.mark.parametrize("bounds", SUPPORTS)
def test_discrete_support_matches(bounds):
    ours = scaling.DiscreteSupport(*bounds)
    theirs = jax_scaling.DiscreteSupport(*bounds)
    assert ours.size == theirs.size
    np.testing.assert_array_equal(ours.arange().numpy(), np.asarray(theirs.arange))


@pytest.mark.parametrize("bounds", SUPPORTS)
@pytest.mark.parametrize("scale", [0.5, 3.0])
def test_logits_to_scalar_and_inverse_transform_match(bounds, scale):
    rng = np.random.default_rng(0)
    ours_s = scaling.DiscreteSupport(*bounds)
    theirs_s = jax_scaling.DiscreteSupport(*bounds)
    logits = (rng.standard_normal((16, ours_s.size)) * scale).astype(np.float32)
    # the expectation is a float32 sum of up to 601 terms as large as the
    # support's end, added in another order on each side: 1e-6 of that end
    support_end = max(abs(bounds[0]), abs(bounds[1]))
    exp = np.asarray(jax_scaling.logits_to_scalar(jnp.asarray(logits), theirs_s))
    value = scaling.logits_to_scalar(torch.from_numpy(logits), ours_s)
    np.testing.assert_allclose(value.numpy(), exp, rtol=1e-6, atol=1e-6 * support_end)
    # h^-1 itself on the same scalars agrees to 1e-6 (test below); composed
    # with the expectation it amplifies the expectation's rounding (through
    # the sqrt(1 + 4 eps |v|) - 1 cancellation), hence 1e-4 relative here
    got = scaling.inverse_scalar_transform(torch.from_numpy(logits), ours_s)
    assert torch.equal(got, scaling._h_inverse(value))
    exp = np.asarray(jax_scaling.inverse_scalar_transform(jnp.asarray(logits), theirs_s))
    np.testing.assert_allclose(got.numpy(), exp, rtol=1e-4, atol=1e-6)


def test_inverse_transform_of_scalars_matches():
    # categorical_distribution=False: h^-1 applied straight to a scalar head
    x = np.random.default_rng(1).uniform(-300, 300, (64, 1)).astype(np.float32)
    support = (-300.0, 301.0, 1.0)
    exp = np.asarray(
        jax_scaling.inverse_scalar_transform(
            jnp.asarray(x), jax_scaling.DiscreteSupport(*support), categorical_distribution=False
        )
    )
    got = scaling.inverse_scalar_transform(
        torch.from_numpy(x), scaling.DiscreteSupport(*support), categorical_distribution=False
    ).numpy()
    np.testing.assert_allclose(got, exp, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("temperature", [1.0, 0.25])
def test_sample_from_visit_counts_deterministic_matches(temperature):
    rng = np.random.default_rng(2)
    counts = rng.integers(0, 30, (12, 5)).astype(np.int32)
    counts[3] = 0  # no visits at all: entropy of an all -inf softmax
    counts[4, 1:] = 0  # one visited action
    exp_a, exp_e = jax_sample(None, jnp.asarray(counts), temperature, deterministic=True)
    got_a, got_e = sample_from_visit_counts(torch.from_numpy(counts), temperature, deterministic=True)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(exp_a))
    np.testing.assert_allclose(got_e.numpy(), np.asarray(exp_e), rtol=1e-6, atol=1e-6)


def test_sample_from_visit_counts_samples_only_visited_actions():
    counts = torch.tensor([[0, 5, 0, 3], [7, 0, 0, 0]])
    g = torch.Generator().manual_seed(0)
    for _ in range(20):
        a, _ = sample_from_visit_counts(counts, 1.0, generator=g)
        assert counts[torch.arange(2), a].min() > 0
