"""The plain references against the port on the CPU at a small width: the
same weights and inputs give the same search and the same learn steps, to
float32 rounding."""
import torch

from conftest import LEARN, SEARCH, small_cell


def test_search_reference_matches_the_port():
    cell = small_cell(SEARCH)
    d = cell.driver
    policy, weights = cell.config_module.build(cell.config, cell.seed, "cpu")
    inputs = d.Inputs(cell.config, cell.traffic, cell.seed, "cpu")
    for i in range(3):
        prog = d.search_call(policy, inputs, cell.traffic, i)
        ref = d.reference_call(cell, weights, inputs, i)
        g = d.gaps(prog, ref)
        assert g["logit_gap"] < 1e-5 and g["value_gap"] < 1e-5
        assert g[f"mismatch@{d.MARGIN:g}"] == 0
        assert g["searched_value_gap"] < 1e-4
        # with the same draws the whole trees agree, not only the robust ones
        assert torch.equal(prog["visit_counts"], ref["visit_counts"])


def test_learn_reference_matches_the_port():
    cell = small_cell(LEARN)
    d = cell.driver
    batches = d.make_batches(cell.config, cell.traffic, cell.seed, "cpu")
    policy, weights = cell.config_module.build(cell.config, cell.seed, "cpu")
    prog = d.program_readings(cell, policy, weights, batches)
    ref = d.reference_readings(cell.config, weights, batches[:3])
    g = d.gaps(prog, ref)
    for k in ("loss_gap", "priority_gap", "grad_gap", "change_gap"):
        assert g[k] < 1e-4, (k, g[k])
