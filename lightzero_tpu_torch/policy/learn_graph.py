"""MuZero's learn step as one CUDA graph, captured once and replayed.

An eager learn step hands the card a few thousand kernels, each through
Python and autograd's dispatch, and at the learn cell's size the host's
dispatch, not the card, sets the pace. ``LearnGraph`` captures the step's
device work once (``torch.cuda.graph``): the loss, its backward, the zero
gradients of the parameters the loss misses, the global-norm clip and the
optimizer's step. Each later step copies its batch into the graph's input
buffers and replays it: the same kernels in the same order on the same
memory, with one launch from the host. The schedule's step, the step count
and the target copy stay on the host (``MuZeroPolicy._finish_step``).

``MuZeroPolicy._captured_step`` decides when, by the step's key
(``MuZeroPolicy._graph_key``: the model, the optimizer and its state, each
parameter group's settings, the batch's shapes and types): the graph of the
same key replays; else the step captures one where the last eager step had
its key, and runs eagerly where it did not. So a capture never meets a
shape, a rate or an optimizer state that an eager step has not set up
first.

What a replay leaves is what the eager step leaves: each parameter's
``.grad`` holds the step's clipped gradient (the graph's own buffers, put
back where an eager step replaced them), and the logs, the priorities and
the gradient norm it returns are copies that the next replay does not
overwrite. The counters the step's kernels keep are kept true: what the
capture counted in ``_build.launches`` and through ``profiling.count``
(``channel_norm.bytes``) is counted again at each replay, and each replay
adds 1 to ``profiling.count("learn_graph.replays")``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from lightzero_tpu_torch import _build
from lightzero_tpu_torch.utils import profiling


def same_key(a, b) -> bool:
    """Whether two of ``MuZeroPolicy._graph_key``'s keys match: the same
    objects, equal values."""
    return a[1] == b[1] and all(x is y for x, y in zip(a[0], b[0]))


class LearnGraph:
    """One learn step of ``policy`` on ``state``, captured for batches like
    ``batch``; the capture runs nothing on the card, so the step that
    captures it performs it with a ``replay``."""

    def __init__(self, policy, state, batch, key):
        self.key = key
        # the .grad buffers come from the graph's memory, as the step's others
        state.optimizer.zero_grad(set_to_none=True)
        self.batch = type(batch)(*(None if x is None else x.clone() for x in batch))
        self.graph = torch.cuda.CUDAGraph()
        before = dict(_build.launches)
        with profiling.captured_counts() as counts, torch.cuda.graph(self.graph):
            logs, priority, params = policy._loss_and_grads(state.model, self.batch)
            norm = policy._clip_and_step(state.optimizer, [p.grad for p in params])
        # the capture launched nothing: its counts are the replays' to add
        self.launches: Dict[str, int] = {k: n - before.get(k, 0)
                                         for k, n in _build.launches.items()
                                         if n != before.get(k, 0)}
        for k, n in self.launches.items():
            _build.launches[k] -= n
        self.counts = counts
        self.grads = [(p, p.grad) for p in params]
        self.outputs = (logs, priority, norm)

    def replay(self, batch) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
        """One learn step on ``batch``: ``(logs, value_priority (B,), the
        gradient norm before clipping)``."""
        for static, x in zip(self.batch, batch):
            if static is not None:
                static.copy_(x)
        for p, g in self.grads:
            if p.grad is not g:
                p.grad = g
        self.graph.replay()
        for k, n in self.launches.items():
            _build.launches[k] += n
        profiling.recount(self.counts)
        profiling.count("learn_graph.replays", 1.0)
        logs, priority, norm = self.outputs
        values = torch.stack([*logs.values(), norm]).unbind()
        return dict(zip(logs, values[:-1])), priority.clone(), values[-1]
