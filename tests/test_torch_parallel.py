"""The port's scale-out on torch.distributed (lightzero_tpu_torch/parallel/)
on the CPU:

- the two-process gloo dry run (``parallel/dryrun.py``), under a timeout of
  its own: its five phases each against one process (see its docstring);
- the dry run's DDP learn steps (MuZero with the SSL loss; UniZero with
  Encoder-Clip acting) against the JAX package's single-device learn step
  from the same params on the same batch: the loss 1e-5 relative, the
  priorities 1e-5 (MuZero) and 1e-4 (UniZero, h^-1 of a 11-atom
  expectation), the new params to 1e-6 where the gradient Adam saw is
  above 1e-6 (Adam's first step is lr * g / (|g| + 1e-8), which moves by
  lr * 1e-8 * err / |g| for a relative error err of g), 2 lr elsewhere,
  those under a quarter of the elements;
- ``ddp_learn_step`` in a one-rank gloo group bit-equal to the plain learn
  step; its refusals;
- ``partition_tasks`` against the JAX package's over a grid of (tasks,
  world, rank); the helpers without a process group.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from lightzero_tpu.config.core import deep_merge as jax_deep_merge
from lightzero_tpu.parallel.distributed import partition_tasks as jax_partition_tasks
from lightzero_tpu.policy.muzero import MuZeroPolicy as JaxMuZeroPolicy
from lightzero_tpu.policy.muzero import TrainBatch as JaxTrainBatch
from lightzero_tpu.policy.muzero import TrainState as JaxTrainState
from lightzero_tpu.policy.unizero import UniZeroPolicy as JaxUniZeroPolicy
from lightzero_tpu_torch.parallel import distributed
from lightzero_tpu_torch.parallel.ddp import ddp_learn_step
from lightzero_tpu_torch.parallel.dryrun import (
    MUZERO_CONFIG,
    UNIZERO_CONFIG,
    random_batch,
    _muzero_policy,
    launch,
)
from lightzero_tpu_torch.policy import MuZeroMTPolicy, UniZeroPolicy
from lightzero_tpu_torch.utils.params_import import state_dict_to_flax
from test_torch_learn import flat

pytestmark = pytest.mark.unittest

DRYRUN_TIMEOUT_S = 240
# the gradient below which a first Adam step is held to 2 lr only
FIRST_STEP_G = 1e-6


@pytest.fixture(scope="module")
def dryrun(tmp_path_factory):
    """The two-process dry run, its phase lines and rank 0's records."""
    out = tmp_path_factory.mktemp("dryrun")
    lines = launch(world_size=2, timeout=DRYRUN_TIMEOUT_S, out_dir=str(out))
    return lines, torch.load(out / "dryrun_records.pt", weights_only=False)


def test_two_process_dry_run_passes_every_phase(dryrun):
    lines, records = dryrun
    for phase in ("muzero_ddp_step", "sharded_search+reanalyze == unsharded",
                  "unizero_ddp_step", "nan step skipped", "multitask_partition == single",
                  "entry ranks train apart", "control_plane"):
        assert phase in lines, lines
    assert sorted(records) == ["multitask_partition", "muzero", "unizero"]


JAX_POLICIES = {"muzero": (JaxMuZeroPolicy, MUZERO_CONFIG),
                "unizero": (JaxUniZeroPolicy, UNIZERO_CONFIG),
                "multitask_partition": (JaxMuZeroPolicy, MUZERO_CONFIG)}


@pytest.mark.parametrize("name", sorted(JAX_POLICIES))
def test_ddp_steps_match_the_jax_single_device_step(dryrun, name):
    rec = dryrun[1][name]
    jax_cls, cfg = JAX_POLICIES[name]
    jax_policy = jax_cls(jax_deep_merge(jax_cls.default_config(), cfg))
    params = jax.tree_util.tree_map(jnp.asarray, state_dict_to_flax(rec["init"]))
    state = JaxTrainState(params=params, target_params=jax.tree_util.tree_map(jnp.copy, params),
                          opt_state=jax_policy.optimizer.init(params),
                          train_iter=jnp.zeros((), jnp.int32))
    batch = JaxTrainBatch(**{k: jnp.asarray(v.numpy().astype(np.int32) if k == "actions"
                                            else v.numpy())
                             for k, v in rec["batch"].items() if v is not None})
    state, logs, prio = jax_policy.forward_learn(state, batch)
    np.testing.assert_allclose(rec["logs"]["total_loss"], float(logs["total_loss"]), rtol=1e-5)
    tol = 1e-5 if name != "unizero" else 1e-4
    np.testing.assert_allclose(rec["priority"].numpy(), np.asarray(prio), rtol=tol, atol=tol)
    # the gradient Adam saw at its first step: clip(g) (+ wd p under Adam);
    # the step is lr * g / (|g| + 1e-8), insensitive to g's rounding unless
    # |g| is near it
    pcfg = jax_policy.cfg
    l2 = float(pcfg.weight_decay) if pcfg.optim_type == "Adam" else 0.0
    g = flat(state_dict_to_flax({n: v + l2 * rec["init"][n] for n, v in rec["grads"].items()}))
    got, exp = flat(state_dict_to_flax(rec["params"])), flat(state.params)
    assert got.keys() == exp.keys() == g.keys()
    lr = float(pcfg.learning_rate)
    for k in exp:
        tight = np.abs(g[k]) > FIRST_STEP_G
        np.testing.assert_allclose(got[k][tight], exp[k][tight], rtol=0, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(got[k], exp[k], rtol=0, atol=2 * lr, err_msg=k)
    loose = sum(int((np.abs(v) <= FIRST_STEP_G).sum()) for v in g.values())
    assert loose <= sum(v.size for v in g.values()) // 4


@pytest.fixture
def one_rank_group(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


def test_ddp_learn_step_at_one_rank_is_the_plain_step(one_rank_group):
    batch = random_batch(16, 5, 2, seed=7)
    plain, ddp = _muzero_policy(), _muzero_policy()
    _, logs, prio = plain.forward_learn(plain.init_train_state(), batch)
    _, ddp_logs, ddp_prio = ddp_learn_step(ddp, ddp.init_train_state(), batch)
    assert ddp.grad_sync is None  # the hook is gone after the step
    assert torch.equal(prio, ddp_prio)
    assert all(float(ddp_logs[k]) == float(v) for k, v in logs.items())
    for p, q in zip(plain.model.parameters(), ddp.model.parameters()):
        assert torch.equal(p, q)


def test_ddp_learn_step_refusals(one_rank_group):
    mt = MuZeroMTPolicy(dict(MUZERO_CONFIG, task_num=2), device="cpu")
    with pytest.raises(NotImplementedError, match="multitask"):
        ddp_learn_step(mt, mt.init_train_state(), None)
    uz = UniZeroPolicy(dict(UNIZERO_CONFIG, accumulation_steps=2), device="cpu")
    with pytest.raises(NotImplementedError, match="accumulation"):
        ddp_learn_step(uz, uz.init_train_state(), None)


@pytest.mark.parametrize("num_tasks", [1, 2, 3, 5, 8, 26])
@pytest.mark.parametrize("world", [1, 2, 3, 4, 8])
def test_partition_tasks_matches_jax(num_tasks, world):
    parts = [distributed.partition_tasks(num_tasks, rank=r, world_size=world)
             for r in range(world)]
    assert parts == [list(jax_partition_tasks(num_tasks, rank=r, world_size=world))
                     for r in range(world)]
    assert sum(parts, []) == list(range(num_tasks))


def test_helpers_without_a_process_group():
    assert not dist.is_initialized()
    assert distributed.init_distributed() == dict(rank=0, world_size=1)
    assert not dist.is_initialized() and distributed.is_main_process()
    distributed.barrier()
    gathered = distributed.all_gather_scalars({"b": 2.0, "a": 1.0})
    assert {k: v.tolist() for k, v in gathered.items()} == {"a": [1.0], "b": [2.0]}
    assert distributed.allreduce_mean_scalars({"x": 3.0}) == {"x": 3.0}
    assert distributed.broadcast_from_main(np.arange(3)).tolist() == [0, 1, 2]
    assert distributed.partition_tasks(3) == [0, 1, 2]
