"""The port's routed MoE (lightzero_tpu_torch/models/unizero_world_model/
moe.py) against the JAX package's dense MoE and against the benchmark's
plain reference (port_bench/reference/unizero_moe.py), at small widths on
the CPU.

- The routed layer against flax's dense one on the same weights, at k = 1
  and k = 2, and with a constructed tie (experts 0 and 1 share their gate
  column, so the tie rule keeps both): the output, the input's gradient
  and every weight's gradient to 1e-5, as the other UniZero parity tests.
- The layer with its shared expert against the reference's block, forward
  and gradients; ``n_shared_experts`` other than 0 and 1 refused.
- The layer's spans and its token counter, kept only while a profile
  records.
- One ``UniZeroMTPolicy`` learn step of the benchmark's ScaleZero
  configuration cut to 2 layers, width 64, 4 experts and 2 tasks against
  the reference's step on the same weights and batch: the loss and the
  priorities to 1e-5 relative, every leaf's clipped gradient to 1e-4 of
  the largest leaf's norm.
- The parameter import refuses a model with a shared expert, both ways.
"""
import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightzero_tpu.models.unizero_world_model import moe as jax_moe
from lightzero_tpu_torch.models.unizero import UniZeroModel
from lightzero_tpu_torch.models.unizero_world_model import moe
from lightzero_tpu_torch.utils import profiling
from lightzero_tpu_torch.utils.params_import import flax_to_state_dict, state_dict_to_flax
from port_bench import harness
from port_bench.reference import common as C
from port_bench.reference import unizero_moe as ref

TOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def close(got, exp, tol=TOL, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(exp), rtol=tol, atol=tol, err_msg=what)


def jax_layer_and_port(D, E, k, seed, tie=False):
    x = np.random.default_rng(seed).standard_normal((4, 7, D)).astype(np.float32)
    layer = jax_moe.MoELayer(D, num_experts=E, num_experts_per_tok=k)
    params = layer.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    rng = np.random.default_rng(seed + 1)
    params = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + (rng.standard_normal(np.shape(v)) * 0.1).astype(np.float32), params)
    if tie:
        params["params"]["gate"]["kernel"][:, 1] = params["params"]["gate"]["kernel"][:, 0]
    port = moe.MoELayer(D, E, k)
    port.load_state_dict(port_weights(params["params"]))
    return layer, params, port, x


def port_weights(tree):
    return {k.split("moe.", 1)[1]: v for k, v in flax_to_state_dict(
        {"_wm": {"Block_0": {"MoELayer_0": tree}}}).items()}


@pytest.mark.parametrize("k, E, tie", [(1, 4, False), (2, 4, False), (1, 3, True), (2, 3, True)])
def test_routed_layer_matches_the_dense_jax_layer_with_gradients(k, E, tie):
    D = 16
    layer, params, port, x = jax_layer_and_port(D, E, k, 3 + k + E, tie)
    cot = np.random.default_rng(7).standard_normal(x.shape).astype(np.float32)

    def objective(p, xx):
        return jnp.sum(layer.apply(p, xx) * cot)

    (jgp, jgx) = jax.grad(objective, argnums=(0, 1))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = port(xt)
    close(y, layer.apply(params, jnp.asarray(x)), what="output")
    (y * torch.from_numpy(cot)).sum().backward()
    close(xt.grad, jgx, what="input gradient")
    exp = port_weights(jax.tree_util.tree_map(np.asarray, jgp)["params"])
    for name, p in port.named_parameters():
        close(p.grad, exp[name], what=name)
    chosen, _ = moe.select(port.gate(torch.from_numpy(x)), k)
    if tie:
        assert bool((chosen.sum(-1) > k).any()), "no token kept more than k experts"
    else:
        assert bool((chosen.sum(-1) == k).all())


def test_shared_expert_matches_the_reference_block():
    D, E, k = 16, 4, 1
    port = moe.MoELayer(D, E, k, 1, torch.Generator().manual_seed(5))
    h = torch.randn((30, D), generator=torch.Generator().manual_seed(6)).requires_grad_(True)
    p = {f"m.{n}": v.detach().clone().requires_grad_(True) for n, v in port.named_parameters()}
    exp = ref.moe(p, "m", h, k, C.FLOAT32, None, ref.new_tally("cpu"))
    got = port(h)
    close(got, exp.detach(), what="output")
    cot = torch.randn(got.shape, generator=torch.Generator().manual_seed(8))
    g_port = torch.autograd.grad((got * cot).sum(), [h, *port.parameters()])
    g_ref = torch.autograd.grad((exp * cot).sum(), [h, *(p[f"m.{n}"] for n, _ in port.named_parameters())],
                                allow_unused=True)
    for (name, _), a, b in zip([("input", None), *port.named_parameters()], g_port, g_ref):
        close(a, torch.zeros_like(a) if b is None else b.detach(), what=name)
    # the shared expert adds its output to every token, unweighted
    without = port.shared
    port.shared = None
    with torch.no_grad():
        close(got.detach() - port(h), without(h).detach())


@pytest.mark.parametrize("n", [2, -1])
def test_more_than_one_shared_expert_is_refused(n):
    with pytest.raises(ValueError, match="n_shared_experts"):
        moe.MoELayer(8, 4, 1, n)


def test_spans_and_the_token_counter_only_while_a_profile_records():
    port = moe.MoELayer(8, 4, 1, 1, torch.Generator().manual_seed(1))
    x = torch.randn((3, 5, 8))
    profiling.record.clear()
    profiling.counters.clear()
    with torch.no_grad():
        port(x)
        assert not profiling.record and not profiling.counters
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            port(x)
    assert [s.name for s in profiling.record] == ["moe.route", "moe.experts", "moe.combine"]
    (counts,) = profiling.counters["moe.tokens_per_expert"]
    assert counts.shape == (4,) and int(counts.sum()) == 15
    profiling.record.clear()
    profiling.counters.clear()


def shrunk_scalezero():
    with open(os.path.join(ROOT, "port_bench/configs/atari_scalezero_moe8.json")) as f:
        config = json.load(f)
    p = config["policy"]
    p["model"].update(observation_shape=[32, 32, 3], num_channels=16, support_scale=10,
                      embed_dim=64, num_heads=4, num_layers=2, num_experts=4, num_tasks=2)
    p.update(task_num=2, num_unroll_steps=4)
    traffic = dict(batch=6, tasks=2, batch_pool=1)
    return config, traffic


def test_one_multitask_learn_step_matches_the_reference():
    config, traffic = shrunk_scalezero()
    mod = harness.load_module(os.path.join(ROOT, "port_bench/configs/atari_scalezero_moe8.py"),
                              "scalezero_config_under_test")
    drv = harness.load_module(os.path.join(ROOT, "port_bench/drivers/learn_unizero_mt.py"),
                              "scalezero_driver_under_test")
    policy, weights = mod.build(config, 2147483947, "cpu")
    batch = drv.make_batches(config, traffic, 2147483947, "cpu")[0]
    assert sorted(set(batch.task_id.tolist())) == [0, 1]
    state = policy.init_train_state()
    state, logs, prio = policy.forward_learn(state, batch)
    grads = {n: p.grad for n, p in state.model.named_parameters()}
    as_dict = {k: getattr(batch, k) for k in ref.ROW_KEYS + ("task_weights",)}
    losses, ref_grads, _, prios, _ = ref.learn_steps(weights, config["policy"], [as_dict], rows=4)
    assert abs(float(logs["total_loss"]) - losses[0]) <= TOL * abs(losses[0])
    close(prio, prios[0], tol=1e-4, what="priorities")
    scale = max(float(torch.linalg.vector_norm(g)) for g in ref_grads.values())
    assert set(grads) == set(ref_grads)
    for n, g in ref_grads.items():
        np.testing.assert_allclose(grads[n].numpy(), g.numpy(), rtol=0, atol=1e-4 * scale,
                                   err_msg=n)
    # the shared experts took a gradient in every layer; the gate none (k = 1)
    for i in range(2):
        assert all(float(grads[f"transformer.blocks.{i}.moe.shared.dense.{j}.weight"].abs().max()) > 0
                   for j in range(3))
        assert float(grads[f"transformer.blocks.{i}.moe.gate.weight"].abs().max()) == 0


def test_params_import_refuses_a_shared_expert_both_ways():
    small = dict(observation_shape=4, action_space_size=2, embed_dim=32, num_heads=4, num_layers=1,
                 max_tokens=16, value_support_size=11, reward_support_size=11,
                 moe_in_transformer=True, num_experts=3)
    with pytest.raises(ValueError, match="shared expert"):
        state_dict_to_flax(UniZeroModel(**small, n_shared_experts=1).state_dict())
    tree = state_dict_to_flax(UniZeroModel(**small).state_dict())
    shared = copy.deepcopy(tree["params"]["_wm"]["Block_0"]["MoELayer_0"]["expert_0"])
    tree["params"]["_wm"]["Block_0"]["MoELayer_0"]["shared_expert"] = shared
    with pytest.raises(ValueError, match="shared expert"):
        flax_to_state_dict(tree)
