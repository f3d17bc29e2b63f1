"""Port vs JAX: the two-player branches of the pUCT search
(lightzero_tpu_torch/search/puct.py against lightzero_tpu/search/puct.py).

The seven golden cases of tests/test_puct_search_golden.py:172-232 (three
one-player, two two-player self-play and two bot-mode cases, players 2
with to_play -1), driven by that file's deterministic fake model in float64
on both sides, tie_break='first' and the same injected Dirichlet noise;
plus a players-2 reuse search (ReZero) with mixed roots. Visit counts must be equal and root values agree
to 1e-5 (float64 on both sides: they agree far closer). A players-2 search
must never reach ``fused_traverse``: it is replaced by a function that
raises."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightzero_tpu.search import RecurrentOutput as JaxRecurrentOutput
from lightzero_tpu.search import RootOutput as JaxRootOutput
from lightzero_tpu.search import SearchConfig as JaxSearchConfig
from lightzero_tpu.search import batch_puct_search as jax_search
from lightzero_tpu_torch.search import RecurrentOutput, RootOutput, SearchConfig, puct
from lightzero_tpu_torch.search import batch_puct_search

pytestmark = pytest.mark.unittest

VALUE_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Eager ops this small gain nothing from intra-op threads, and the
    suite runs several test processes at once: their thread pools would
    fight over the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def fake_logits(latent, num_actions, lib=np):
    return lib.stack([lib.sin(latent * (a + 1) * 1.7) for a in range(num_actions)], -1) * 2.0


def _jax_search(obs, legal, sims, A, discount, to_play, players, noise, reuse=None):
    with jax.enable_x64(True):
        def recurrent_fn(params, rng, action, embedding):
            nl = jnp.tanh(embedding * 1.3 + (action + 1) * 0.37)
            return JaxRecurrentOutput(reward=jnp.sin(nl * 3.0) * 0.5, value=jnp.cos(nl * 2.0) * 0.5,
                                      prior_logits=fake_logits(nl, A, jnp), embedding=nl)

        latent = np.asarray(obs, np.float64)
        root = JaxRootOutput(prior_logits=jnp.asarray(fake_logits(latent, A)),
                             value=jnp.asarray(np.cos(latent * 2.0) * 0.5),
                             embedding=jnp.asarray(latent))
        cfg = JaxSearchConfig(num_simulations=sims, discount=discount, players=players,
                              tie_break="first")
        kw = {} if reuse is None else dict(true_action=jnp.asarray(reuse[0], jnp.int32),
                                           reuse_value=jnp.asarray(reuse[1]))
        out = jax_search(None, jax.random.PRNGKey(0), root, recurrent_fn, cfg, jnp.asarray(legal),
                         to_play=jnp.asarray(to_play, jnp.int32), with_noise=noise is not None,
                         noise=None if noise is None else jnp.asarray(noise), **kw)
        return np.asarray(out.visit_counts), np.asarray(out.root_value)


def _torch_search(obs, legal, sims, A, discount, to_play, players, noise, reuse=None):
    def recurrent_fn(action, embedding):
        nl = torch.tanh(embedding * 1.3 + (action + 1) * 0.37)
        return RecurrentOutput(reward=torch.sin(nl * 3.0) * 0.5, value=torch.cos(nl * 2.0) * 0.5,
                               prior_logits=fake_logits(nl, A, torch), embedding=nl)

    latent = torch.tensor(obs, dtype=torch.float64)
    root = RootOutput(prior_logits=fake_logits(latent, A, torch), value=torch.cos(latent * 2.0) * 0.5,
                      embedding=latent)
    cfg = SearchConfig(num_simulations=sims, discount=discount, players=players, tie_break="first")
    kw = {} if reuse is None else dict(true_action=torch.tensor(reuse[0]),
                                       reuse_value=torch.tensor(reuse[1], dtype=torch.float64))
    out = batch_puct_search(root, recurrent_fn, cfg, torch.from_numpy(legal),
                            to_play=torch.tensor(to_play, dtype=torch.int32),
                            with_noise=noise is not None,
                            noise=None if noise is None else torch.from_numpy(noise),
                            device="cpu", **kw)
    return out.visit_counts.numpy(), out.root_value.numpy()


def _case(obs, legal_lists, sims, A, discount, to_play, players, noise_seed=None):
    B = len(obs)
    legal = np.zeros((B, A), bool)
    for i, la in enumerate(legal_lists):
        legal[i, la] = True
    noise = None
    if noise_seed is not None:
        rng = np.random.RandomState(noise_seed)
        noise = np.zeros((B, A))
        for i, la in enumerate(legal_lists):
            noise[i, la] = rng.dirichlet([0.3] * len(la))
    return obs, legal, sims, A, discount, to_play, players, noise


GOLDEN = {
    # tests/test_puct_search_golden.py:172-232
    "single_player_full_actions": _case([0.1, 0.5, 0.9, -0.3], [list(range(5))] * 4, 30, 5,
                                        0.997, [-1] * 4, 1),
    "single_player_with_dirichlet_noise": _case([0.2, -0.8], [list(range(4))] * 2, 25, 4, 0.997,
                                                [-1, -1], 1, noise_seed=7),
    "single_player_masked_legal_actions": _case([0.4, -0.6, 1.2],
                                                [[0, 2, 4], [1, 3, 5, 6], list(range(7))], 40, 7,
                                                0.997, [-1] * 3, 1),
    "two_player_board_game_backup": _case([0.15, -0.45], [list(range(6))] * 2, 30, 6, 1.0,
                                          [1, 2], 2),
    "two_player_masked_with_noise": _case([0.33, 0.77, -0.2],
                                          [[0, 1, 4, 8], [2, 3, 5], list(range(9))], 35, 9, 1.0,
                                          [2, 1, 1], 2, noise_seed=3),
    "bot_mode_board_game_single_player_backup": _case([0.15, -0.45, 0.6], [list(range(7))] * 3,
                                                      50, 7, 1.0, [-1] * 3, 2),
    "bot_mode_masked_with_noise": _case([0.33, -0.9], [[0, 1, 3, 5], list(range(7))], 40, 7, 1.0,
                                        [-1, -1], 2, noise_seed=11),
}


@pytest.fixture
def no_kernel(monkeypatch):
    """A players-2 search that reaches the descent kernel's wrapper fails."""
    def refuse(*args, **kwargs):
        raise AssertionError("a players-2 search reached fused_traverse")

    monkeypatch.setattr(puct, "fused_traverse", refuse)


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_golden_case_matches_jax(name, no_kernel, monkeypatch):
    args = GOLDEN[name]
    if args[6] == 1:
        monkeypatch.undo()  # the one-player case takes the kernel's plain version
    exp_counts, exp_values = _jax_search(*args)
    got_counts, got_values = _torch_search(*args)
    np.testing.assert_array_equal(got_counts, exp_counts)
    np.testing.assert_allclose(got_values, exp_values, rtol=VALUE_TOL, atol=VALUE_TOL)


def test_two_player_reuse_search_matches_jax(no_kernel):
    """ReZero's reuse search under players == 2: roots of player 1, player
    2 and bot mode (-1), the reuse arm's value signed by the root's player."""
    obs, legal, sims, A, discount, to_play, players, noise = _case(
        [0.2, -0.6, 0.45, 0.9], [list(range(6)), [0, 2, 3, 5], list(range(6)), [1, 2, 4]],
        30, 6, 1.0, [1, 2, -1, 2], 2, noise_seed=5)
    reuse = ([2, 3, 0, 4], [0.4, -0.3, 0.25, 0.6])
    exp_counts, exp_values = _jax_search(obs, legal, sims, A, discount, to_play, players, noise,
                                         reuse)
    got_counts, got_values = _torch_search(obs, legal, sims, A, discount, to_play, players, noise,
                                           reuse)
    np.testing.assert_array_equal(got_counts, exp_counts)
    np.testing.assert_allclose(got_values, exp_values, rtol=VALUE_TOL, atol=VALUE_TOL)
    # the reuse arm's sign matters: the same search with the values negated
    # for the two-player roots differs
    flipped = ([2, 3, 0, 4], [-0.4, 0.3, 0.25, -0.6])
    other, _ = _torch_search(obs, legal, sims, A, discount, to_play, players, noise, flipped)
    assert not np.array_equal(other, got_counts)


def test_two_player_search_differs_from_one_player():
    """The same roots searched as one player (to_play -1) and as two players
    give other visit counts: the sign flips are live."""
    obs, legal, sims, A, discount, _, players, noise = GOLDEN["two_player_board_game_backup"]
    two, _ = _torch_search(obs, legal, sims, A, discount, [1, 2], players, noise)
    one, _ = _torch_search(obs, legal, sims, A, discount, [-1, -1], players, noise)
    assert not np.array_equal(two, one)
