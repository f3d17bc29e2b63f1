"""Each configuration's FLOP count from shapes against PyTorch's own count
of the port's call (``FlopCounterMode``: convolutions and matrix products,
a multiply-add as 2), at a small width."""
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import LEARN, SEARCH, small_cell


def counted(fn) -> float:
    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


def test_muzero_inference_flops():
    cell = small_cell(SEARCH)
    policy, _ = cell.config_module.build(cell.config, cell.seed, "cpu")
    B = 3
    obs = torch.rand((B, *cell.config["policy"]["model"]["observation_shape"]))
    with torch.no_grad():
        out = policy.model.initial_inference(obs)
        assert counted(lambda: policy.model.initial_inference(obs)) == (
            B * cell.config_module.flops_initial(cell.config))
        action = torch.arange(B) % 6
        assert counted(lambda: policy.model.recurrent_inference(out.latent_state, action)) == (
            B * cell.config_module.flops_recurrent(cell.config))


def test_unizero_learn_step_flops():
    cell = small_cell(LEARN)
    policy, _ = cell.config_module.build(cell.config, cell.seed, "cpu")
    state = policy.init_train_state()
    batch = cell.driver.make_batches(cell.config, cell.traffic, cell.seed, "cpu")[0]
    B = int(cell.traffic["batch"])
    assert counted(lambda: policy.forward_learn(state, batch)) == (
        cell.config_module.flops_learn_step(cell.config, B))
