"""MinAtar-class grid envs as batched tensor envs
(``lightzero_tpu/envs/minatar_like.py``): asterix, freeway, space invaders
and seaquest analogues on a 10x10 grid.

- Asterix: lanes of left- or right-moving entities; collect gold (+1),
  touching an enemy ends the episode. Actions: 0 noop, 1 up, 2 down,
  3 left, 4 right. Observation (10, 10, 4): [player, enemy, gold,
  direction].
- Freeway: cross 8 lanes of cadenced traffic from the bottom to the top,
  +1 per crossing; a hit sends the chicken back. Ends by time limit only.
  Actions: 0 noop, 1 up, 2 down. Observation (10, 10, 3): [chicken, cars,
  speed].
- Space invaders: a 3x6 alien block sweeps and descends; shoot it down
  (+1 an alien) before it lands or you are shot. Actions: 0 noop, 1 left,
  2 right, 3 fire. Observation (10, 10, 4): [player, aliens, player bullet,
  enemy bullet].
- Seaquest: ram fish head-on for +1, any other contact kills; surface (row
  0) to refill the oxygen, running out kills. Actions: 0 noop, 1 up,
  2 down, 3 left, 4 right. Observation (10, 10, 4): [sub, fish, direction,
  oxygen].

Each env auto-resets where an episode ends and keeps the JAX env's flags:
freeway's ``truncated`` is its ``done``, the other three report
``truncated`` False even at ``max_steps``, as the JAX envs (which leave
``EnvStep.truncated`` at its default) do. Every action is legal.

Each env's random draws of a step (``draw_step``) are kept apart from its
deterministic transition (``transition``), so that a caller can hand in
draws made elsewhere, as the tests hand in the JAX env's. The JAX steps draw
the spawn lane and the spawn test from one key; here they are independent
draws of the same distributions.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from lightzero_tpu_torch.envs.base import EnvStep, TensorEnv

S = 10  # grid side
N_AL_R, N_AL_C = 3, 6  # space invaders' alien block


def grid(B: int, rows: torch.Tensor, cols: torch.Tensor, values,
         valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, S, S) float32 planes with ``values`` added at (rows, cols), each
    (B, ...) broadcast together. As a JAX scatter does, a negative index
    counts from the end and an index outside the grid after that is
    dropped; cells hit twice sum (``.at[].add``)."""
    rows, cols = torch.broadcast_tensors(rows.long(), cols.long())
    values = torch.broadcast_to(torch.as_tensor(values, dtype=torch.float32, device=rows.device),
                                rows.shape)
    rows = torch.where(rows < 0, rows + S, rows)
    cols = torch.where(cols < 0, cols + S, cols)
    keep = (rows >= 0) & (rows < S) & (cols >= 0) & (cols < S)
    if valid is not None:
        keep = keep & torch.broadcast_to(valid, rows.shape)
    bidx = torch.arange(B, device=rows.device).reshape((B,) + (1,) * (rows.dim() - 1))
    bidx = torch.broadcast_to(bidx, rows.shape)
    out = torch.zeros((B, S, S), dtype=torch.float32, device=rows.device)
    out.index_put_((bidx[keep], rows[keep], cols[keep]), values[keep], accumulate=True)
    return out


def _select(done: torch.Tensor, fresh: NamedTuple, new: NamedTuple) -> NamedTuple:
    """Per env: the fresh episode's state where ``done``, else the new one."""
    B = done.shape[0]
    return type(new)(*(torch.where(done.reshape((B,) + (1,) * (n.dim() - 1)), r, n)
                       for r, n in zip(fresh, new)))


def _full(B: int, value, device, dtype=torch.int64) -> torch.Tensor:
    return torch.full((B,), value, dtype=dtype, device=device)


def _step_out(state, obs, reward, done, num_actions: int, truncated=None) -> EnvStep:
    B, dev = done.shape[0], done.device
    return EnvStep(
        state=state, obs=obs, reward=reward.to(torch.float32), done=done,
        legal_mask=torch.ones((B, num_actions), dtype=torch.bool, device=dev),
        to_play=torch.full((B,), -1, dtype=torch.int32, device=dev),
        truncated=torch.zeros_like(done) if truncated is None else truncated,
    )


def _lane_spawn(active, col, right, lane, spawn_u, spawn_right, spawn_prob: float):
    """Spawn into lane ``lane`` (B,) where ``spawn_u`` < ``spawn_prob`` and
    the lane is empty: at column 0 moving right or at S - 1 moving left.
    -> (active, col, right, spawn (B,))."""
    bidx = torch.arange(lane.shape[0], device=lane.device)
    spawn = (spawn_u < spawn_prob) & ~active[bidx, lane]
    active, col, right = active.clone(), col.clone(), right.clone()
    active[bidx, lane] = active[bidx, lane] | spawn
    col[bidx, lane] = torch.where(spawn, torch.where(spawn_right, 0, S - 1), col[bidx, lane])
    right[bidx, lane] = torch.where(spawn, spawn_right, right[bidx, lane])
    return active, col, right, spawn


def _drift(active, col, right, cadence, move_every: int):
    """Entities move one column every ``move_every`` steps and leave at the
    walls: -> (active, col, cadence)."""
    cadence = torch.remainder(cadence + 1, move_every)
    do_move = (cadence == 0)[:, None]
    ncol = col + torch.where(right, 1, -1) * (do_move & active).long()
    off = (ncol < 0) | (ncol >= S)
    return active & ~off, torch.clamp(ncol, 0, S - 1), cadence


class _GridEnv(TensorEnv):
    """What the four envs share: every action legal, and a step is the
    env's ``transition`` under fresh ``draw_step`` draws."""

    num_players = 1

    def legal_mask(self, state) -> torch.Tensor:
        return torch.ones((state.t.shape[0], self.action_space_size), dtype=torch.bool,
                          device=state.t.device)

    def step(self, state, action: torch.Tensor, generator: torch.Generator) -> EnvStep:
        return self.transition(state, action, self.draw_step(action.shape[0], generator))


# =========================================================== Asterix-like
class AsterixState(NamedTuple):
    pr: torch.Tensor  # (B,) player row
    pc: torch.Tensor  # (B,) player column
    active: torch.Tensor  # (B, 8) bool entity alive in lane i (rows 1..8)
    col: torch.Tensor  # (B, 8) entity column
    right: torch.Tensor  # (B, 8) bool moving right
    gold: torch.Tensor  # (B, 8) bool treasure (else enemy)
    cadence: torch.Tensor  # (B,) move-every-k counter
    t: torch.Tensor  # (B,)


class AsterixDraws(NamedTuple):
    lane: torch.Tensor  # (B,) int64 in [0, 8): the lane a spawn may enter
    spawn_u: torch.Tensor  # (B,) float32 uniform: a spawn where < spawn_prob
    right: torch.Tensor  # (B,) bool: the spawn moves right
    gold: torch.Tensor  # (B,) bool, p 0.3: the spawn is gold


class AsterixGridEnv(_GridEnv):
    observation_shape = (S, S, 4)
    action_space_size = 5

    def __init__(self, max_steps: int = 500, spawn_prob: float = 0.2, move_every: int = 3):
        self.max_steps = max_steps
        self.spawn_prob = float(spawn_prob)
        self.move_every = int(move_every)

    @staticmethod
    def observe(s: AsterixState) -> torch.Tensor:
        B = s.pr.shape[0]
        lanes = torch.arange(1, 9, device=s.pr.device)[None, :]
        act = s.active.to(torch.float32)
        return torch.stack([
            grid(B, s.pr, s.pc, 1.0),
            grid(B, lanes, s.col, act * ~s.gold),
            grid(B, lanes, s.col, act * s.gold),
            grid(B, lanes, s.col, act * torch.where(s.right, 1.0, 0.5)),
        ], dim=-1)

    @staticmethod
    def initial_state(B: int, device) -> AsterixState:
        z8 = torch.zeros((B, 8), dtype=torch.bool, device=device)
        return AsterixState(pr=_full(B, S // 2, device), pc=_full(B, S // 2, device), active=z8,
                            col=torch.zeros((B, 8), dtype=torch.int64, device=device), right=z8,
                            gold=z8, cadence=_full(B, 0, device), t=_full(B, 0, device))

    @staticmethod
    def draw_step(B: int, generator: torch.Generator) -> AsterixDraws:
        dev = generator.device
        return AsterixDraws(
            lane=torch.randint(0, 8, (B,), generator=generator, device=dev),
            spawn_u=torch.rand((B,), generator=generator, device=dev),
            right=torch.rand((B,), generator=generator, device=dev) < 0.5,
            gold=torch.rand((B,), generator=generator, device=dev) < 0.3,
        )

    def transition(self, s: AsterixState, action: torch.Tensor, d: AsterixDraws) -> EnvStep:
        action = action.long()
        B, dev = action.shape[0], action.device
        bidx = torch.arange(B, device=dev)
        # the player stays on rows 1..8, so that every lane threatens
        pr = torch.clamp(s.pr - (action == 1).long() + (action == 2).long(), 1, 8)
        pc = torch.clamp(s.pc - (action == 3).long() + (action == 4).long(), 0, S - 1)
        active, ncol, cadence = _drift(s.active, s.col, s.right, s.cadence, self.move_every)
        active, ncol, nright, spawn = _lane_spawn(active, ncol, s.right, d.lane, d.spawn_u,
                                                  d.right, self.spawn_prob)
        ngold = s.gold.clone()
        ngold[bidx, d.lane] = torch.where(spawn, d.gold, s.gold[bidx, d.lane])
        # collisions at the player's cell
        lanes = torch.arange(1, 9, device=dev)[None, :]
        hit = active & (lanes == pr[:, None]) & (ncol == pc[:, None])
        reward = (hit & ngold).sum(dim=1)
        killed = (hit & ~ngold).any(dim=1)
        active = active & ~hit  # consumed either way
        t = s.t + 1
        done = killed | (t >= self.max_steps)
        out = _select(done, self.initial_state(B, dev),
                      AsterixState(pr, pc, active, ncol, nright, ngold, cadence, t))
        return _step_out(out, self.observe(out), reward, done, self.action_space_size)

    def reset(self, num_envs: int, generator: torch.Generator) -> Tuple[AsterixState, torch.Tensor]:
        s = self.initial_state(num_envs, generator.device)
        return s, self.observe(s)


# =========================================================== Freeway-like
class FreewayState(NamedTuple):
    chicken: torch.Tensor  # (B,) row (its column is fixed at the centre)
    car_col: torch.Tensor  # (B, 8)
    car_speed: torch.Tensor  # (B, 8) a car moves every k steps (1..3)
    car_right: torch.Tensor  # (B, 8) bool
    timer: torch.Tensor  # (B, 8) per-car cadence counters
    t: torch.Tensor  # (B,)


class FreewayDraws(NamedTuple):
    """The traffic of the episode a reset starts."""

    car_col: torch.Tensor  # (B, 8) int64 in [0, S)
    car_speed: torch.Tensor  # (B, 8) int64 in [1, 4)
    car_right: torch.Tensor  # (B, 8) bool, p 0.5


class FreewayGridEnv(_GridEnv):
    observation_shape = (S, S, 3)
    action_space_size = 3
    col = S // 2

    def __init__(self, max_steps: int = 250):
        self.max_steps = max_steps

    def observe(self, s: FreewayState) -> torch.Tensor:
        B = s.chicken.shape[0]
        lanes = torch.arange(1, 9, device=s.chicken.device)[None, :]
        return torch.stack([
            grid(B, s.chicken, torch.full_like(s.chicken, self.col), 1.0),
            grid(B, lanes, s.car_col, 1.0),
            grid(B, lanes, s.car_col, s.car_speed.to(torch.float32) / 3.0),
        ], dim=-1)

    @staticmethod
    def draw_step(B: int, generator: torch.Generator) -> FreewayDraws:
        dev = generator.device
        return FreewayDraws(
            car_col=torch.randint(0, S, (B, 8), generator=generator, device=dev),
            car_speed=torch.randint(1, 4, (B, 8), generator=generator, device=dev),
            car_right=torch.rand((B, 8), generator=generator, device=dev) < 0.5,
        )

    @staticmethod
    def initial_state(d: FreewayDraws) -> FreewayState:
        B, dev = d.car_col.shape[0], d.car_col.device
        return FreewayState(chicken=_full(B, S - 1, dev), car_col=d.car_col.long(),
                            car_speed=d.car_speed.long(), car_right=d.car_right,
                            timer=torch.zeros((B, 8), dtype=torch.int64, device=dev),
                            t=_full(B, 0, dev))

    def transition(self, s: FreewayState, action: torch.Tensor, d: FreewayDraws) -> EnvStep:
        action = action.long()
        dev = action.device
        chicken = torch.clamp(s.chicken - (action == 1).long() + (action == 2).long(), 0, S - 1)
        timer = s.timer + 1
        move = timer >= s.car_speed
        timer = torch.where(move, 0, timer)
        car_col = torch.remainder(s.car_col + torch.where(s.car_right, 1, -1) * move.long(), S)
        lanes = torch.arange(1, 9, device=dev)[None, :]
        hit = ((lanes == chicken[:, None]) & (car_col == self.col)).any(dim=1)
        crossed = chicken == 0
        reward = crossed.to(torch.float32)
        chicken = torch.where(hit | crossed, S - 1, chicken)
        t = s.t + 1
        done = t >= self.max_steps
        out = _select(done, self.initial_state(d),
                      FreewayState(chicken, car_col, s.car_speed, s.car_right, timer, t))
        return _step_out(out, self.observe(out), reward, done, self.action_space_size,
                         truncated=done)

    def reset(self, num_envs: int, generator: torch.Generator) -> Tuple[FreewayState, torch.Tensor]:
        s = self.initial_state(self.draw_step(num_envs, generator))
        return s, self.observe(s)


# ===================================================== SpaceInvaders-like
class InvadersState(NamedTuple):
    pc: torch.Tensor  # (B,) player column (bottom row)
    aliens: torch.Tensor  # (B, 3, 6) bool
    a_row: torch.Tensor  # (B,) top row of the alien block
    a_col: torch.Tensor  # (B,) left column of the alien block
    a_right: torch.Tensor  # (B,) bool the block's direction
    cadence: torch.Tensor  # (B,)
    pb_r: torch.Tensor  # (B,) the player's bullet (-1 = none)
    pb_c: torch.Tensor
    eb_r: torch.Tensor  # (B,) the enemy bullet (-1 = none)
    eb_c: torch.Tensor
    t: torch.Tensor  # (B,)


class InvadersDraws(NamedTuple):
    fire: torch.Tensor  # (B,) bool, p 0.3: the aliens fire if they can
    column: torch.Tensor  # (B,) int64 in [0, 6): the block column that fires


def _first_true(x: torch.Tensor) -> torch.Tensor:
    """argmax of a bool (B, n) along dim 1: the first True, 0 if none."""
    n = x.shape[1]
    idx = torch.arange(n, device=x.device)
    return torch.where(x, idx, n).min(dim=1).values.remainder(n)


class SpaceInvadersGridEnv(_GridEnv):
    observation_shape = (S, S, 4)
    action_space_size = 4

    def __init__(self, max_steps: int = 400, move_every: int = 3):
        self.max_steps = max_steps
        self.move_every = int(move_every)

    @staticmethod
    def observe(s: InvadersState) -> torch.Tensor:
        B, dev = s.pc.shape[0], s.pc.device
        rr = torch.clamp(s.a_row[:, None, None] + torch.arange(N_AL_R, device=dev)[None, :, None],
                         0, S - 1)
        cc = torch.clamp(s.a_col[:, None, None] + torch.arange(N_AL_C, device=dev)[None, None, :],
                         0, S - 1)
        return torch.stack([
            grid(B, torch.full_like(s.pc, S - 1), s.pc, 1.0),
            grid(B, rr, cc, s.aliens.to(torch.float32)),
            grid(B, torch.clamp(s.pb_r, 0, S - 1), s.pb_c, 1.0, valid=s.pb_r >= 0),
            grid(B, torch.clamp(s.eb_r, 0, S - 1), s.eb_c, 1.0, valid=s.eb_r >= 0),
        ], dim=-1)

    @staticmethod
    def initial_state(B: int, device) -> InvadersState:
        return InvadersState(
            pc=_full(B, S // 2, device),
            aliens=torch.ones((B, N_AL_R, N_AL_C), dtype=torch.bool, device=device),
            a_row=_full(B, 0, device), a_col=_full(B, 1, device),
            a_right=_full(B, True, device, torch.bool), cadence=_full(B, 0, device),
            pb_r=_full(B, -1, device), pb_c=_full(B, 0, device), eb_r=_full(B, -1, device),
            eb_c=_full(B, 0, device), t=_full(B, 0, device))

    @staticmethod
    def draw_step(B: int, generator: torch.Generator) -> InvadersDraws:
        dev = generator.device
        return InvadersDraws(
            fire=torch.rand((B,), generator=generator, device=dev) < 0.3,
            column=torch.randint(0, N_AL_C, (B,), generator=generator, device=dev),
        )

    def transition(self, s: InvadersState, action: torch.Tensor, d: InvadersDraws) -> EnvStep:
        action = action.long()
        B, dev = action.shape[0], action.device
        bidx = torch.arange(B, device=dev)
        pc = torch.clamp(s.pc - (action == 1).long() + (action == 2).long(), 0, S - 1)
        # the player's bullet: fired when none is in flight, moves up 1 a step
        fire = (action == 3) & (s.pb_r < 0)
        pb_r = torch.where(fire, S - 2, s.pb_r - (s.pb_r >= 0).long())
        pb_c = torch.where(fire, pc, s.pb_c)
        # the block sweeps, and descends at a wall, on its cadence
        cadence = torch.remainder(s.cadence + 1, self.move_every)
        do_move = cadence == 0
        col_any = s.aliens.any(dim=1)
        ncols = col_any.sum(dim=1)
        left_edge = s.a_col + _first_true(col_any)
        right_edge = s.a_col + (N_AL_C - 1 - _first_true(col_any.flip(1)))
        at_wall = torch.where(s.a_right, right_edge >= S - 1, left_edge <= 0)
        bounce = do_move & at_wall & (ncols > 0)
        a_right = torch.where(bounce, ~s.a_right, s.a_right)
        a_row = s.a_row + bounce.long()
        a_col = s.a_col + torch.where(do_move & ~bounce, torch.where(a_right, 1, -1), 0)
        # the player's bullet against the block
        rel_r, rel_c = pb_r - a_row, pb_c - a_col
        in_block = (pb_r >= 0) & (rel_r >= 0) & (rel_r < N_AL_R) & (rel_c >= 0) & (rel_c < N_AL_C)
        rr, rc = torch.clamp(rel_r, 0, N_AL_R - 1), torch.clamp(rel_c, 0, N_AL_C - 1)
        hit_alien = in_block & s.aliens[bidx, rr, rc]
        aliens = s.aliens.clone()
        aliens[bidx, rr, rc] = s.aliens[bidx, rr, rc] & ~hit_alien
        pb_r = torch.where(hit_alien | (pb_r < 0), -1, pb_r)
        reward = hit_alien.to(torch.float32)
        # the enemy bullet: the lowest alien of a random column fires when free
        column = aliens[bidx, :, d.column]  # (B, 3)
        col_live = column.any(dim=1)
        lowest = N_AL_R - 1 - _first_true(column.flip(1))
        e_fire = (s.eb_r < 0) & col_live & d.fire
        eb_r = torch.where(e_fire, a_row + lowest + 1, s.eb_r + (s.eb_r >= 0).long())
        eb_c = torch.where(e_fire, a_col + d.column, s.eb_c)
        shot = (eb_r == S - 1) & (eb_c == pc)
        eb_r = torch.where(eb_r >= S, -1, eb_r)
        any_alien = aliens.flatten(1).any(dim=1)
        landed = any_alien & (a_row + N_AL_R - 1 >= S - 1)
        t = s.t + 1
        done = shot | landed | ~any_alien | (t >= self.max_steps)
        out = _select(done, self.initial_state(B, dev),
                      InvadersState(pc, aliens, a_row, a_col, a_right, cadence, pb_r, pb_c,
                                    eb_r, eb_c, t))
        return _step_out(out, self.observe(out), reward, done, self.action_space_size)

    def reset(self, num_envs: int, generator: torch.Generator) -> Tuple[InvadersState, torch.Tensor]:
        s = self.initial_state(num_envs, generator.device)
        return s, self.observe(s)


# ========================================================== Seaquest-like
class SeaquestState(NamedTuple):
    pr: torch.Tensor  # (B,) sub row
    pc: torch.Tensor  # (B,) sub column
    oxygen: torch.Tensor  # (B,) remaining
    active: torch.Tensor  # (B, 6) bool fish in lanes (rows 2..7)
    col: torch.Tensor  # (B, 6)
    right: torch.Tensor  # (B, 6) bool
    cadence: torch.Tensor  # (B,)
    t: torch.Tensor  # (B,)


class SeaquestDraws(NamedTuple):
    lane: torch.Tensor  # (B,) int64 in [0, 6)
    spawn_u: torch.Tensor  # (B,) float32 uniform: a spawn where < spawn_prob
    right: torch.Tensor  # (B,) bool: the spawn moves right


class SeaquestGridEnv(_GridEnv):
    observation_shape = (S, S, 4)
    action_space_size = 5

    def __init__(self, max_steps: int = 400, oxygen_max: int = 60, spawn_prob: float = 0.25,
                 move_every: int = 2):
        self.max_steps = max_steps
        self.oxygen_max = int(oxygen_max)
        self.spawn_prob = float(spawn_prob)
        self.move_every = int(move_every)

    def observe(self, s: SeaquestState) -> torch.Tensor:
        B = s.pr.shape[0]
        lanes = torch.arange(2, 8, device=s.pr.device)[None, :]
        act = s.active.to(torch.float32)
        oxy = (s.oxygen.to(torch.float32) / self.oxygen_max)[:, None, None].expand(B, S, S)
        return torch.stack([
            grid(B, s.pr, s.pc, 1.0),
            grid(B, lanes, s.col, act),
            grid(B, lanes, s.col, act * torch.where(s.right, 1.0, 0.5)),
            oxy,
        ], dim=-1)

    def initial_state(self, B: int, device) -> SeaquestState:
        z6 = torch.zeros((B, 6), dtype=torch.bool, device=device)
        return SeaquestState(pr=_full(B, 0, device), pc=_full(B, S // 2, device),
                             oxygen=_full(B, self.oxygen_max, device), active=z6,
                             col=torch.zeros((B, 6), dtype=torch.int64, device=device), right=z6,
                             cadence=_full(B, 0, device), t=_full(B, 0, device))

    @staticmethod
    def draw_step(B: int, generator: torch.Generator) -> SeaquestDraws:
        dev = generator.device
        return SeaquestDraws(
            lane=torch.randint(0, 6, (B,), generator=generator, device=dev),
            spawn_u=torch.rand((B,), generator=generator, device=dev),
            right=torch.rand((B,), generator=generator, device=dev) < 0.5,
        )

    def transition(self, s: SeaquestState, action: torch.Tensor, d: SeaquestDraws) -> EnvStep:
        action = action.long()
        B, dev = action.shape[0], action.device
        dr = (action == 2).long() - (action == 1).long()
        dc = (action == 4).long() - (action == 3).long()
        pr = torch.clamp(s.pr + dr, 0, S - 1)
        pc = torch.clamp(s.pc + dc, 0, S - 1)
        oxygen = torch.where(pr == 0, self.oxygen_max, s.oxygen - 1)
        active, ncol, cadence = _drift(s.active, s.col, s.right, s.cadence, self.move_every)
        active, ncol, nright, _ = _lane_spawn(active, ncol, s.right, d.lane, d.spawn_u, d.right,
                                              self.spawn_prob)
        # contact: moving sideways into a fish catches it (+1), any other kills
        lanes = torch.arange(2, 8, device=dev)[None, :]
        contact = active & (lanes == pr[:, None]) & (ncol == pc[:, None])
        head_on = contact & (((dc > 0)[:, None] & ~nright) | ((dc < 0)[:, None] & nright))
        reward = head_on.sum(dim=1)
        killed = (contact & ~head_on).any(dim=1) | (oxygen <= 0)
        active = active & ~contact
        t = s.t + 1
        done = killed | (t >= self.max_steps)
        out = _select(done, self.initial_state(B, dev),
                      SeaquestState(pr, pc, oxygen, active, ncol, nright, cadence, t))
        return _step_out(out, self.observe(out), reward, done, self.action_space_size)

    def reset(self, num_envs: int, generator: torch.Generator) -> Tuple[SeaquestState, torch.Tensor]:
        s = self.initial_state(num_envs, generator.device)
        return s, self.observe(s)
