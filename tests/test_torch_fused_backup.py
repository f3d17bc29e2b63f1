"""The fused expand and backup (lightzero_tpu_torch/search/fused_backup.py).

On the CPU: the wrapper takes the plain version ``fused_backup_reference``
for CPU tensors and raises for other devices; ``puct._expand_and_backup``
sends two-player searches and float64 trees to the plain version, and
one-player float32 searches to the wrapper; and the plain version gives
bitwise the trees that the backup gave before its body moved
(``_backup_before_the_move``, a copy kept here) on a seeded one-player
float32 search and a float64 two-player search: the searches where the
move's one change, how the discount reaches the device, could show.

On the card (marked ``benchmark``, skipped without CUDA): the kernel
``csrc/fused_backup.cu`` is held bitwise to the plain version on every tree
tensor after whole searches (``CHECK_SEARCHES`` in
``search/fused_backup_checks.py``: the search cell's shape,
terminal stops, A=18, A=37, and each of the kernel's options), its launches
are counted once a simulation, and a one-player search synchronises with the
host nowhere. tests/conftest.py imports JAX, which the card's machine lacks,
so run them there without it:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_fused_backup.py``.
This file imports no JAX."""
from typing import Optional

import numpy as np
import pytest
import torch

import lightzero_tpu_torch.search.puct as puct
from lightzero_tpu_torch.search.fused_backup import fused_backup, fused_backup_reference
from lightzero_tpu_torch.search.fused_backup_checks import (
    CHECK_SEARCHES,
    check_recurrent_fn,
    check_search,
)
from lightzero_tpu_torch.search.tree import Tree, map_embedding
from lightzero_tpu_torch.search.types import RecurrentOutput, RootOutput, SearchConfig

pytestmark = pytest.mark.unittest

# the batch of the CPU's runs of CHECK_SEARCHES
CPU_B = 8


def _backup_before_the_move(
    cfg: SearchConfig,
    tree: Tree,
    st,
    sim: int,
    out: RecurrentOutput,
    prior_is_logits: bool = False,
    value_override: Optional[torch.Tensor] = None,
) -> Tree:
    """puct._expand_and_backup as it stood before its body moved to
    fused_backup_reference: the yardstick that the moved body is held to,
    bitwise. Its one difference: the discount reaches the device through
    torch.tensor, a copy from the host."""
    B, N, A = tree.num_trees, tree.num_nodes, tree.num_actions
    dev = tree.value_sum.device
    dtype = tree.value_sum.dtype
    new_idx = sim + 1
    bidx = torch.arange(B, device=dev)

    legal_mask = (
        out.legal_mask
        if out.legal_mask is not None
        else torch.ones((B, A), dtype=torch.bool, device=dev)
    )
    terminal = (
        out.terminal if out.terminal is not None else torch.zeros((B,), dtype=torch.bool, device=dev)
    )
    # trees that stopped at an existing terminal node do NOT expand
    do_expand = ~st.leaf_is_terminal_node

    # --- expand (Node.expand, ptree_mz.py:46-69) ---
    logits = out.prior_logits.to(dtype)
    if prior_is_logits:
        prior = torch.where(legal_mask, logits, -1e9)
    else:
        prior = torch.softmax(torch.where(legal_mask, logits, -torch.inf), dim=-1)
        prior = torch.where(legal_mask, prior, 0.0)

    def row_write(arr, new_row):
        m = do_expand.reshape((B,) + (1,) * (arr.dim() - 2))
        arr[:, new_idx] = torch.where(m, new_row.to(arr.dtype), arr[:, new_idx])
        return arr

    link = tree.children[bidx, st.parent, st.last_action]
    tree.children[bidx, st.parent, st.last_action] = torch.where(
        do_expand, torch.full_like(link, new_idx), link
    )
    row_write(tree.prior, prior)
    row_write(tree.legal, legal_mask)
    row_write(tree.reward, out.reward)
    row_write(tree.raw_value, out.value)
    row_write(tree.to_play, st.virtual_to_play)
    row_write(tree.terminal, terminal)
    if out.is_chance is not None:
        row_write(tree.is_chance, out.is_chance)
    map_embedding(row_write, tree.embedding, out.embedding)

    # --- backup ---
    # the recorded path plus the new leaf for expanding trees; trees stopped
    # at a terminal node already have the leaf at path[depth]
    leaf_pos = torch.where(do_expand, st.depth + 1, st.depth)
    P = st.path.shape[1]
    pos = torch.arange(P, device=dev)[None, :]
    exp_mask = (pos == leaf_pos[:, None]) & do_expand[:, None]  # (B, P)
    path = torch.where(exp_mask, new_idx, st.path)
    node_r = torch.where(exp_mask, out.reward.to(dtype)[:, None], st.path_reward)
    pre_vsum = torch.where(exp_mask, 0.0, st.path_vsum)
    pre_visit = torch.where(exp_mask, 0.0, st.path_visit)
    valid = pos < (leaf_pos + 1)[:, None]  # (B, P)
    value = out.value.to(dtype)
    if value_override is not None:
        value = torch.where(st.reuse_hit, value_override.to(dtype), value)
    two_p = cfg.players == 2
    if two_p:
        # one-player semantics where the leaf has no player (bot mode,
        # puct.py:642-648); else the rewards and values of the nodes of the
        # leaf's player change sign on their way up
        leaf_to_play = st.virtual_to_play
        one_p = (leaf_to_play == -1)[:, None]  # (B, 1)
        same = torch.where(exp_mask, leaf_to_play[:, None], st.path_to_play) == leaf_to_play[:, None]
        node_r_signed = torch.where(same & ~one_p, -node_r, node_r)
    else:
        node_r_signed = node_r

    # bootstrap recurrence (right to left): contrib at the leaf is its value,
    # contrib_i = r_{i+1} + g * contrib_{i+1}. A suffix composition of affine
    # maps g_i(x) = a_i x + b_i (identity past the leaf), composed by
    # doubling in log2(P) steps (puct.py:650-677 uses an associative scan).
    r_next = torch.cat([node_r_signed[:, 1:], torch.zeros((B, 1), dtype=dtype, device=dev)],
                       dim=1)
    valid_next = torch.cat(
        [valid[:, 1:], torch.zeros((B, 1), dtype=torch.bool, device=dev)], dim=1
    )
    a_sfx = torch.where(valid_next, torch.tensor(cfg.discount, dtype=dtype, device=dev), 1.0)
    b_sfx = torch.where(valid_next, r_next, 0.0)
    k = 1
    while k < P:
        # (A, B)[i] <- (A[i] * A[i+k], A[i] * B[i+k] + B[i]); identity past P
        a_far = torch.cat([a_sfx[:, k:], torch.ones((B, k), dtype=dtype, device=dev)], dim=1)
        b_far = torch.cat([b_sfx[:, k:], torch.zeros((B, k), dtype=dtype, device=dev)], dim=1)
        a_sfx, b_sfx = a_sfx * a_far, a_sfx * b_far + b_sfx
        k *= 2
    contrib = a_sfx * value[:, None] + b_sfx
    if two_p:
        contrib = torch.where(same | one_p, contrib, -contrib)
    contrib = torch.where(valid, contrib, 0.0)

    # each path node appears once per path, so the scatter-add has a single
    # term per node (invalid positions add 0 to node 0)
    safe_path = torch.where(valid, path, 0)
    tree.value_sum.scatter_add_(1, safe_path, contrib)
    tree.visit_count.scatter_add_(1, safe_path, valid.to(tree.visit_count.dtype))

    # post-backup node values from the recorded pre-backup stats
    node_value = (pre_vsum + contrib) / (pre_visit + 1.0)
    if two_p:
        node_value = torch.where(one_p, node_value, -node_value)
    q = node_r + cfg.discount * node_value
    vmin = torch.minimum(tree.vmin, torch.min(torch.where(valid, q, torch.inf), dim=1).values)
    vmax = torch.maximum(tree.vmax, torch.max(torch.where(valid, q, -torch.inf), dim=1).values)
    return tree._replace(vmin=vmin, vmax=vmax)


def assert_trees_equal(got: Tree, exp: Tree) -> None:
    """Every tensor of the two trees bitwise equal; for the priors, the
    largest gap in float32 steps is reported."""
    for name in Tree._fields:
        g, e = getattr(got, name), getattr(exp, name)
        if name == "embedding":
            map_embedding(lambda x, y: torch.testing.assert_close(x, y, rtol=0, atol=0), g, e)
            continue
        if torch.equal(g, e):
            continue
        msg = f"tree.{name} differs in {int((g != e).sum())} of {g.numel()} entries"
        if name == "prior":
            bits = lambda x: x.contiguous().view(torch.int32).long()  # noqa: E731
            msg += f"; the largest gap is {int((bits(g) - bits(e)).abs().max())} float32 steps"
        raise AssertionError(msg)


def run(name: str, device, B=None):
    search, args, kwargs = check_search(name, device, B=B)
    return search(*args, **kwargs)


def two_player_search(dtype: torch.dtype, sims: int = 12, B: int = 6, A: int = 4):
    """A seeded two-player search (players 1 and 2 alternate) on the CPU."""
    rng = np.random.default_rng(5)
    root = RootOutput(prior_logits=torch.from_numpy(rng.standard_normal((B, A))).to(dtype),
                      value=torch.from_numpy(rng.uniform(-1, 1, B)).to(dtype),
                      embedding=torch.from_numpy(rng.standard_normal((B, 4))).to(dtype))
    legal = torch.ones((B, A), dtype=torch.bool)
    legal[1, 2] = legal[3, 0] = False
    noise = torch.from_numpy(rng.dirichlet(np.full(A, 0.3), B)).to(dtype) * legal
    to_play = torch.from_numpy(rng.integers(1, 3, B)).to(torch.int32)
    to_play[0] = -1  # a tree against the bot: one-player semantics under players == 2
    cfg = SearchConfig(num_simulations=sims, tie_break="first", players=2)
    return puct.batch_puct_search(root, check_recurrent_fn(A), cfg, legal, to_play=to_play,
                                  noise=noise, device="cpu")


def captured_backup(name: str = "terminal_stops", sim: int = 5):
    """The arguments of one simulation's backup in a CPU run of a check
    search, each tensor cloned."""
    seen = {}
    orig = puct._expand_and_backup

    def capture(cfg, tree, st, s, out, *args, **kwargs):
        if s == sim:
            clone = lambda x: x.clone() if isinstance(x, torch.Tensor) else x  # noqa: E731
            seen.update(cfg=cfg, tree=Tree(*(map_embedding(clone, v) for v in tree)),
                        st=type(st)(*(clone(v) for v in st)), out=type(out)(*(
                            map_embedding(clone, v) for v in out)), args=args, kwargs=kwargs)
        return orig(cfg, tree, st, s, out, *args, **kwargs)

    puct._expand_and_backup = capture
    try:
        run(name, "cpu")
    finally:
        puct._expand_and_backup = orig
    return seen


def test_cpu_tensors_take_the_plain_version():
    c = captured_backup()
    exp_tree = Tree(*(map_embedding(torch.clone, v) for v in c["tree"]))
    before = fused_backup.launches
    got = fused_backup(c["cfg"], c["tree"], c["st"], 5, c["out"])
    exp = fused_backup_reference(c["cfg"], exp_tree, c["st"], 5, c["out"])
    assert_trees_equal(got, exp)
    assert fused_backup.launches == before  # only kernel launches count


def test_other_devices_raise():
    c = captured_backup()
    meta = lambda x: x.to("meta") if isinstance(x, torch.Tensor) else x  # noqa: E731
    tree = Tree(*(map_embedding(meta, v) for v in c["tree"]))
    st = type(c["st"])(*(meta(v) for v in c["st"]))
    out = type(c["out"])(*(map_embedding(meta, v) for v in c["out"]))
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_backup(c["cfg"], tree, st, 5, out)


def test_routing(monkeypatch):
    """One-player float32 searches go through the wrapper, once a
    simulation; two-player searches and float64 trees take the plain
    version directly."""
    calls = []

    def counted(*args, **kwargs):
        calls.append(args[3])
        return fused_backup(*args, **kwargs)

    monkeypatch.setattr(puct, "fused_backup", counted)
    run("value_override", "cpu", B=CPU_B)
    assert calls == list(range(20))
    calls.clear()
    run("prior_is_logits", "cpu", B=CPU_B)  # Gumbel's search, through puct's routing
    assert calls == list(range(20))
    calls.clear()
    two_player_search(torch.float32)
    two_player_search(torch.float64)
    assert calls == []


@pytest.mark.parametrize("name", ["terminal_stops", "two_player_f64"])
def test_plain_version_gives_the_trees_of_the_backup_before_the_move(name, monkeypatch):
    def search():
        if name == "two_player_f64":
            return two_player_search(torch.float64)
        return run(name, "cpu")

    monkeypatch.setattr(puct, "_expand_and_backup", _backup_before_the_move)
    exp = search()
    monkeypatch.setattr(puct, "_expand_and_backup", fused_backup_reference)
    got = search()
    assert_trees_equal(got.tree, exp.tree)
    assert int(got.tree.visit_count[:, 0].min()) == got.tree.num_nodes


@pytest.mark.benchmark
@pytest.mark.parametrize("name", [c[0] for c in CHECK_SEARCHES])
def test_kernel_matches_the_plain_version_on_the_card(name, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    sims = next(c[3] for c in CHECK_SEARCHES if c[0] == name)
    before = fused_backup.launches
    got = run(name, "cuda")
    assert fused_backup.launches - before == sims
    monkeypatch.setattr(puct, "fused_backup", fused_backup_reference)
    exp = run(name, "cuda")
    assert fused_backup.launches - before == sims
    assert_trees_equal(got.tree, exp.tree)


@pytest.mark.benchmark
def test_a_one_player_search_does_not_synchronise_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    search, args, kwargs = check_search("a18", "cuda")
    search(*args, **kwargs)  # builds the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        search(*args, **kwargs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
