"""Plain reference of MuZero's conv model and of its batched pUCT search.

The model is LightZero's Atari MuZero (``lzero/model/muzero_model.py``,
``common.py``): the DownSample representation on NHWC frames, the dynamics
(a 3x3 conv of the latent and the action's one-hot planes, LN, plus the
latent, relu, res blocks, then the reward head), and the prediction (res
blocks, then 1x1-conv value and policy heads on the flattened (h, w, c)
map). The search is LightZero's ctree pUCT (``lzero/mcts/ctree/
ctree_muzero/lib/cnode.cpp``): root priors from the softmax of the legal
logits mixed with the Dirichlet noise, one visit at the root before the
first simulation, selection by the pUCT score with the MinMax-normalised
value, mean-Q of the visited children for unvisited ones, expansion of one
leaf a simulation, and the discounted backup that updates the MinMax
statistics at every node of the path, root included.

Departures from the published description, all of which the program under
test makes too (they are the semantics the benchmark holds it to):

- LayerNorm in place of BatchNorm, over the channel axis, eps 1e-6; SAME
  padding as XLA pads (the extra row below), 2x2 average pools without
  padding; no bias in any convolution (the JAX package's flax modules).
- No SimNorm on the latent (the configuration's source sets
  ``use_sim_norm``; the port has no such option).
- Ties in the pUCT argmax: the children whose scores lie within 1e-6 of the
  best are tied, and the one with the largest of a table of uniforms wins
  (row t of a (N + 1, B, A) table of ``torch.rand`` from the call's
  generator serves depth t, one table a simulation). The ctree draws its
  own random tie-break.
- A node's mean-Q sums its visited children's r + discount V from the first
  action to the last; below the root the parent's mean-Q is mixed in with
  weight 1; the MinMax normalisation divides by max(max - min, 0.01) and is
  off until max > min.

Everything runs in float32 on whatever device the tensors are on, vectorised
over the batch of trees, with ``rnd`` the format of the conv and matmul
operands (``common.FLOAT32`` or ``common.TF32``).

Besides each tree's visit counts and value, ``search`` returns each tree's
smallest selection margin: over every selection the tree made, the smallest
distance of a competing child's score from the tie threshold (best - 1e-6).
A tree whose margin is below a rounding scale could have chosen otherwise
under any other order of float32 sums; the comparison leaves such trees out
of the exact check and counts them.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.nn import functional as F

from port_bench.reference import common as C

TIE_EPSILON = 1e-6


def representation(p: C.Params, obs: torch.Tensor, rnd: C.Rounding) -> torch.Tensor:
    x = C.downsample(obs, p, "representation_network.downsample", rnd)
    i = 0
    while f"representation_network.res.{i}.conv.0.weight" in p:
        x = C.res_block(x, p, f"representation_network.res.{i}", rnd)
        i += 1
    return x


def _head(x: torch.Tensor, p: C.Params, net: str, i: int, j: int, rnd: C.Rounding):
    """conv1x1 ``i`` -> LN ``i`` -> relu -> flatten (h, w, c) -> MLP ``j`` of
    one hidden layer."""
    r = torch.relu(C.layer_norm(C.conv(x, p[f"{net}.conv.{i}.weight"], 1, rnd), p,
                                f"{net}.norm.{i}"))
    return C.mlp(r.reshape(r.shape[0], -1), p, f"{net}.mlp.{j}", 1, rnd)


def prediction(p: C.Params, latent: torch.Tensor, rnd: C.Rounding):
    x = latent
    i = 0
    while f"prediction_network.res.{i}.conv.0.weight" in p:
        x = C.res_block(x, p, f"prediction_network.res.{i}", rnd)
        i += 1
    return (_head(x, p, "prediction_network", 0, 0, rnd),
            _head(x, p, "prediction_network", 1, 1, rnd))


def dynamics(p: C.Params, latent: torch.Tensor, action: torch.Tensor, num_actions: int,
             rnd: C.Rounding):
    B, hh, ww, _ = latent.shape
    planes = F.one_hot(action.long(), num_actions).to(latent.dtype)[:, None, None, :]
    x = torch.cat([latent, planes.expand(B, hh, ww, num_actions)], dim=-1)
    x = C.layer_norm(C.conv(x, p["dynamics_network.conv.0.weight"], 1, rnd), p,
                     "dynamics_network.norm.0")
    x = torch.relu(x + latent)
    i = 0
    while f"dynamics_network.res.{i}.conv.0.weight" in p:
        x = C.res_block(x, p, f"dynamics_network.res.{i}", rnd)
        i += 1
    return x, _head(x, p, "dynamics_network", 1, 0, rnd)


def initial_inference(p: C.Params, obs: torch.Tensor, rnd: C.Rounding):
    latent = representation(p, obs, rnd)
    value_logits, policy_logits = prediction(p, latent, rnd)
    return latent, value_logits, policy_logits


def recurrent_inference(p: C.Params, latent: torch.Tensor, action: torch.Tensor,
                        num_actions: int, rnd: C.Rounding):
    nxt, reward_logits = dynamics(p, latent, action, num_actions, rnd)
    value_logits, policy_logits = prediction(p, nxt, rnd)
    return nxt, reward_logits, value_logits, policy_logits


def _normalize(q: torch.Tensor, vmin: torch.Tensor, vmax: torch.Tensor, delta_max: float):
    delta = (vmax - vmin)[:, None]
    return torch.where(delta > 0, (q - vmin[:, None]) / torch.clamp(delta, min=delta_max), q)


@torch.no_grad()
def search(p: C.Params, cfg: Dict, obs: torch.Tensor, legal: torch.Tensor, noise: torch.Tensor,
           generator: torch.Generator, rnd: C.Rounding = C.FLOAT32) -> Dict[str, torch.Tensor]:
    """Search B roots for ``cfg['num_simulations']`` simulations.

    ``noise`` (B, A) is the Dirichlet draw mixed into the root priors;
    ``generator`` draws the tie-break tables. Returns the root visit counts
    (B, A), the searched root values (B,), the root's value and policy
    logits from the initial inference, each tree's selection margin and the
    range of its MinMax statistics (max - min of the r + discount V seen)."""
    sims, A = int(cfg["num_simulations"]), legal.shape[1]
    scale = int(cfg["model"]["support_scale"])
    gamma, c_base, c_init = float(cfg["discount_factor"]), float(cfg["pb_c_base"]), float(cfg["pb_c_init"])
    w, delta_max = float(cfg["root_noise_weight"]), float(cfg["value_delta_max"])
    dev = obs.device
    B, N = obs.shape[0], sims + 1
    bidx = torch.arange(B, device=dev)

    latent0, value_logits0, policy_logits0 = initial_inference(p, obs, rnd)
    root_value = C.logits_to_value(value_logits0, scale)
    prior0 = torch.softmax(torch.where(legal, policy_logits0, -torch.inf), dim=-1)
    prior0 = torch.where(legal, prior0, 0.0)
    prior0 = torch.where(legal, prior0 * (1.0 - w) + noise * w, 0.0)

    visit = torch.zeros((B, N), device=dev)
    value_sum = torch.zeros((B, N), device=dev)
    reward = torch.zeros((B, N), device=dev)
    prior = torch.zeros((B, N, A), device=dev)
    legal_t = torch.zeros((B, N, A), dtype=torch.bool, device=dev)
    children = torch.full((B, N, A), -1, dtype=torch.long, device=dev)
    emb = torch.zeros((B, N) + tuple(latent0.shape[1:]), device=dev)
    prior[:, 0], legal_t[:, 0], visit[:, 0], emb[:, 0] = prior0, legal, 1.0, latent0
    vmin = torch.full((B,), 1e6, device=dev)
    vmax = torch.full((B,), -1e6, device=dev)
    margin = torch.full((B,), torch.inf, device=dev)

    for sim in range(sims):
        uniforms = torch.rand((N + 1, B, A), generator=generator, device=dev, dtype=torch.float32)
        node = torch.zeros(B, dtype=torch.long, device=dev)
        parent_q = torch.zeros(B, device=dev)
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        leaf_parent = torch.zeros(B, dtype=torch.long, device=dev)
        leaf_action = torch.zeros(B, dtype=torch.long, device=dev)
        path = [node]
        for t in range(N):
            kids = children[bidx, node]
            exists = kids >= 0
            safe = torch.clamp(kids, min=0)
            c_visit = torch.where(exists, torch.gather(visit, 1, safe), 0.0)
            c_vsum = torch.gather(value_sum, 1, safe)
            c_value = torch.where(exists & (c_visit > 0), c_vsum / torch.clamp(c_visit, min=1.0), 0.0)
            c_reward = torch.where(exists, torch.gather(reward, 1, safe), 0.0)
            ok = legal_t[bidx, node]
            q = c_reward + gamma * c_value
            visited = (c_visit > 0) & ok
            qv = torch.where(visited, q, 0.0)
            total_q = qv[:, 0]
            for a in range(1, A):
                total_q = total_q + qv[:, a]
            total_n = visited.sum(dim=1).to(torch.float32)
            is_root = t == 0
            if is_root:
                mean_q = torch.where(total_n > 0, total_q / torch.clamp(total_n, min=1.0),
                                     (parent_q + total_q) / (total_n + 1.0))
            else:
                mean_q = (parent_q + total_q) / (total_n + 1.0)
            pv = visit[bidx, node][:, None]
            pb_c = torch.log((pv + c_base + 1.0) / c_base) + c_init
            pb_c = pb_c * torch.sqrt(pv) / (c_visit + 1.0)
            v_score = torch.clamp(_normalize(q, vmin, vmax, delta_max), 0.0, 1.0)
            pq = torch.clamp(_normalize(mean_q[:, None], vmin, vmax, delta_max), 0.0, 1.0)
            v_score = torch.where(c_visit > 0, v_score, pq)
            scores = torch.where(ok, pb_c * prior[bidx, node] + v_score, -torch.inf)
            best = scores.max(dim=1, keepdim=True).values
            threshold = best - TIE_EPSILON
            near = scores >= threshold
            action = torch.argmax(torch.where(near, uniforms[t], -torch.inf), dim=1)
            # the selection margin: how far the competitors of the best
            # child lie from the tie threshold
            first_best = torch.argmax(scores, dim=1)
            others = ok & (torch.arange(A, device=dev)[None, :] != first_best[:, None])
            dist = torch.where(others, torch.abs(scores - threshold), torch.inf).min(dim=1).values
            margin = torch.where(done, margin, torch.minimum(margin, dist))

            nxt = torch.gather(kids, 1, action[:, None])[:, 0]
            stop = ~done & (nxt < 0)
            leaf_parent = torch.where(stop, node, leaf_parent)
            leaf_action = torch.where(stop, action, leaf_action)
            parent_q = torch.where(done, parent_q, mean_q)
            move = ~done & (nxt >= 0)
            node = torch.where(move, nxt, node)
            done = done | stop
            path.append(torch.where(move, nxt, torch.full_like(nxt, -1)))
            if bool(done.all()):
                break

        new = sim + 1
        nxt_latent, reward_logits, value_logits, policy_logits = recurrent_inference(
            p, emb[bidx, leaf_parent], leaf_action, A, rnd)
        r_new = C.logits_to_value(reward_logits, scale)
        v_new = C.logits_to_value(value_logits, scale)
        children[bidx, leaf_parent, leaf_action] = new
        prior[:, new] = torch.softmax(policy_logits, dim=-1)
        legal_t[:, new] = True
        reward[:, new] = r_new
        emb[:, new] = nxt_latent

        # the path from the root to the new leaf; -1 past each tree's leaf
        depth = sum((n >= 0).long() for n in path[1:])
        full = torch.stack(path + [torch.full_like(path[0], -1)], dim=1)
        full[bidx, depth + 1] = new
        g = v_new
        for i in range(full.shape[1] - 1, -1, -1):
            n_i = full[:, i]
            on = n_i >= 0
            safe = torch.clamp(n_i, min=0)
            value_sum[bidx, safe] += torch.where(on, g, 0.0)
            visit[bidx, safe] += on.to(torch.float32)
            r_i = reward[bidx, safe]
            q_i = r_i + gamma * (value_sum[bidx, safe] / torch.clamp(visit[bidx, safe], min=1.0))
            vmin = torch.where(on, torch.minimum(vmin, q_i), vmin)
            vmax = torch.where(on, torch.maximum(vmax, q_i), vmax)
            g = torch.where(on, r_i + gamma * g, g)

    root_kids = children[:, 0]
    counts = torch.where(root_kids >= 0, torch.gather(visit, 1, torch.clamp(root_kids, min=0)), 0.0)
    return dict(visit_counts=counts.to(torch.int32), searched_value=value_sum[:, 0] / visit[:, 0],
                predicted_value=root_value, policy_logits=policy_logits0, margin=margin,
                value_range=vmax - vmin)
