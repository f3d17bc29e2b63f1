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


# the training half: scalar_transform, phi_transform, cross_entropy_loss and
# visit_count_temperature, to 1e-6 (elementwise float32 arithmetic in the
# same order on both sides)


@pytest.mark.parametrize("delta", [1.0, 2.5])
def test_scalar_transform_matches(delta):
    x = np.random.default_rng(3).uniform(-500, 500, 256).astype(np.float32)
    x[:3] = [0.0, -0.0, 1e-7]
    exp = np.asarray(jax_scaling.scalar_transform(jnp.asarray(x), delta=delta))
    got = scaling.scalar_transform(torch.from_numpy(x), delta=delta).numpy()
    np.testing.assert_allclose(got, exp, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bounds", SUPPORTS)
@pytest.mark.parametrize("smoothing", [0.0, 0.01])
def test_phi_transform_matches_at_the_ends_and_with_smoothing(bounds, smoothing):
    rng = np.random.default_rng(4)
    lo, hi = bounds[0], bounds[0] + bounds[2] * (scaling.DiscreteSupport(*bounds).size - 1)
    x = rng.uniform(lo * 1.5, hi * 1.5, (8, 32)).astype(np.float32)
    # the support's ends, beyond them (clamped), and exact atoms
    x[0, :6] = [lo, hi, lo - 100.0, hi + 100.0, 0.0, bounds[2]]
    exp = np.asarray(jax_scaling.phi_transform(
        jax_scaling.DiscreteSupport(*bounds), jnp.asarray(x), smoothing))
    got = scaling.phi_transform(scaling.DiscreteSupport(*bounds), torch.from_numpy(x), smoothing)
    np.testing.assert_allclose(got.numpy(), exp, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, rtol=1e-5)
    assert got[0, 2, 0] == pytest.approx(1.0 - smoothing + smoothing / got.shape[-1])


def test_cross_entropy_loss_matches():
    rng = np.random.default_rng(5)
    pred = (rng.standard_normal((6, 5, 21)) * 3).astype(np.float32)
    target = rng.dirichlet(np.ones(21), (6, 5)).astype(np.float32)
    target[0, 0] = 0.0  # a masked target row: zero loss
    exp = np.asarray(jax_scaling.cross_entropy_loss(jnp.asarray(pred), jnp.asarray(target)))
    got = scaling.cross_entropy_loss(torch.from_numpy(pred), torch.from_numpy(target)).numpy()
    np.testing.assert_allclose(got, exp, rtol=1e-6, atol=1e-6)
    assert got[0, 0] == 0.0


@pytest.mark.parametrize("decay", [True, False])
def test_visit_count_temperature_matches_around_its_thresholds(decay):
    threshold = 1000
    for steps in (0, 499, 500, 501, 749, 750, 751, 10_000):
        exp = jax_scaling.visit_count_temperature(decay, 0.25, threshold, steps)
        assert scaling.visit_count_temperature(decay, 0.25, threshold, steps) == exp
    if decay:
        assert [scaling.visit_count_temperature(True, 0.25, threshold, s)
                for s in (499, 500, 749, 750)] == [1.0, 0.5, 0.5, 0.25]
