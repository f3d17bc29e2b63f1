"""The two learn cells beside the first benchmark's: ScaleZero's multitask
MoE learner (``atari_scalezero_moe8.learn_mt8.b512``) and MuZero's
(``atari_muzero.learn.b256``), cut small on the CPU: their entries
resolve, a sound run passes its checks, a traced run reads the metrics the
cell lists, every planted fault and the control fail a check, and the
FLOP counts from shapes equal PyTorch's own count of a learn step. The
harness's look for a chip is skipped by calling the cell's driver
directly."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench import harness

MT = "atari_scalezero_moe8.learn_mt8.b512"
MZ = "atari_muzero.learn.b256"


def small_cell(workload: str, trace: bool = False) -> harness.Cell:
    """The cell with its widths, depth, batch and tasks cut so that a test
    run holds it; every other key as the cell has it."""
    cell = harness.make_cell(harness.load_spec(), workload, 2147483947, 1.0, trace, "cpu")
    policy = cell.config["policy"]
    if workload == MT:
        policy["model"].update(observation_shape=[32, 32, 3], num_channels=16, support_scale=10,
                               embed_dim=64, num_heads=4, num_layers=2, num_experts=4,
                               num_tasks=2)
        policy.update(task_num=2, num_unroll_steps=4)
        cell.traffic.update(batch=6, tasks=2, trace_steps=3, reference_rows=4)
    else:
        policy["model"].update(observation_shape=[32, 32, 4], num_channels=16, support_scale=10)
        cell.traffic.update(batch=4, trace_steps=3)
    return cell


def correct(checks) -> bool:
    return all(c.ok for c in checks)


def test_the_scalezero_cell_is_at_the_published_widths():
    cell = harness.make_cell(harness.load_spec(), MT, 1, 1.0, False, "cpu")
    p = cell.config["policy"]
    m = p["model"]
    assert (m["embed_dim"], m["num_experts"], m["num_experts_per_tok"], m["n_shared_experts"]) == (
        768, 8, 1, 1)
    assert (m["action_space_size"], m["observation_shape"], p["num_unroll_steps"]) == (
        18, [64, 64, 3], 10)
    assert cell.traffic["batch"] == p["batch_size"] == 512 == 8 * 64
    assert cell.traffic["tasks"] == p["task_num"] == m["num_tasks"] == 8
    assert cell.config["reduced"] == []


@pytest.mark.parametrize("workload", [MT, MZ])
def test_the_cells_resolve(workload):
    spec = harness.load_spec()
    entry, conf, traffic = harness.resolve(spec, workload)
    assert entry["chips"] == 1 and traffic["driver"] in ("learn_unizero_mt", "learn_muzero")
    cell = harness.make_cell(spec, workload, 1, 1.0, False, "cpu")
    assert callable(cell.config_module.build) and callable(cell.driver.run)
    assert set(cell.driver.LIMITS) == {"loss_gap", "priority_gap", "grad_gap", "change_gap"}
    assert [m["name"] for m in harness.end_to_end_for(spec, workload)] == [
        "learn_samples_per_s", "setup_s"]
    for m in harness.per_layer_for(spec, workload):
        assert callable(harness.reader(m["name"]))


def test_a_program_without_the_shared_expert_is_refused_before_any_draw():
    cell = small_cell(MT)
    cell.config["policy"]["model"]["n_shared_experts"] = 0
    with pytest.raises(RuntimeError, match="shared expert"):
        cell.config_module.build(cell.config, cell.seed, "cpu")


@pytest.mark.parametrize("workload", [MT, MZ])
def test_a_sound_run_is_correct(workload):
    cell = small_cell(workload)
    out = cell.driver.run(cell)
    assert correct(out["checks"]), out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"learn_samples_per_s", "setup_s"}


@pytest.mark.parametrize("workload", [MT, MZ])
def test_a_traced_run_reads_its_metrics(workload):
    cell = small_cell(workload, trace=True)
    out = cell.driver.run(cell)
    assert correct(out["checks"]), out["checks"]
    tr = out["trace"]
    ctx = dict(trace=tr, counters=tr.counters)
    read = {m["name"]: harness.reader(m["name"])(ctx)
            for m in harness.per_layer_for(harness.load_spec(), workload)}
    assert read["mfu.learn"] > 0
    assert read["device_idle_share.learn"] is None  # no device on the CPU
    if workload == MT:
        assert read["moe_host_share.learn_mt"] > 0
        assert read["expert_load_max.learn_mt"] >= 1.0
        assert read["readback_wait_share.learn"] > 0


@pytest.mark.parametrize("workload, fault", [(MT, f) for f in (
    "unchanged", "half_batch", "altered", "no_shared", "dense_eighth", "dropped_expert")]
    + [(MZ, f) for f in ("unchanged", "half_batch", "altered")])
def test_a_broken_run_is_not_correct(workload, fault):
    cell = small_cell(workload)
    assert fault in cell.driver.FAULTS
    with cell.driver.planted(fault):
        out = cell.driver.run(cell)
    assert not correct(out["checks"]), out["checks"]


@pytest.mark.parametrize("workload", [MT, MZ])
def test_the_control_is_not_correct(workload):
    cell = small_cell(workload)
    control = cell.driver.readings(cell)["control"]
    checks = [harness.Check(k, control[k], v) for k, v in cell.driver.LIMITS.items()]
    assert not correct(checks), control


@pytest.mark.parametrize("workload", [MT, MZ])
def test_learn_step_flops(workload):
    cell = small_cell(workload)
    policy, _ = cell.config_module.build(cell.config, cell.seed, "cpu")
    state = policy.init_train_state()
    batch = cell.driver.make_batches(cell.config, cell.traffic, cell.seed, "cpu")[0]
    B = int(cell.traffic["batch"])
    with FlopCounterMode(display=False) as counter:
        policy.forward_learn(state, batch)
    if workload == MT:
        expected = cell.config_module.flops_learn_step(cell.config, B)
    else:
        expected = cell.driver.flops_learn_step(cell.config_module, cell.config, B)
    assert float(counter.get_total_flops()) == expected


def test_the_routings_near_a_tie_are_pinned_to_the_programs():
    """The reference takes the program's selection where its own two
    competing logits lie under PIN_MARGIN apart: with the margin widened
    to take every token, a program that routed every token to its
    second-best expert is followed exactly."""
    from port_bench.reference import common as C
    from port_bench.reference import unizero_moe as ref

    g = torch.Generator().manual_seed(3)
    p = {"m.gate.weight": torch.randn((4, 8), generator=g)}
    for e in range(4):
        for j, shape in enumerate([(32, 8), (32, 8), (8, 32)]):
            p[f"m.experts.{e}.dense.{j}.weight"] = torch.randn(shape, generator=g) / 4
    h = torch.randn((20, 8), generator=g)
    logits = h @ p["m.gate.weight"].t()
    second = torch.sort(logits, dim=-1, descending=True).values[:, 1:2]
    program = torch.where(logits == second, 1.0, 0.0)  # its top-1 is the reference's second
    own = ref.moe(p, "m", h, 1, C.FLOAT32, None, ref.new_tally("cpu"))
    saved, ref.PIN_MARGIN = ref.PIN_MARGIN, float("inf")
    try:
        tally = ref.new_tally("cpu")
        pinned = ref.moe(p, "m", h, 1, C.FLOAT32, program, tally)
    finally:
        ref.PIN_MARGIN = saved
    follows = sum(program[:, e:e + 1] * ref.swiglu(p, f"m.experts.{e}", h, C.FLOAT32)
                  for e in range(4))
    torch.testing.assert_close(pinned, follows)
    assert int(tally["pinned"]) == int(tally["changed"]) == 20
    assert not torch.allclose(own, pinned)
