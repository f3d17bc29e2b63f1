from lightzero_tpu_torch.envs.base import EnvStep, TensorEnv
from lightzero_tpu_torch.envs.cartpole import CartPoleEnv
from lightzero_tpu_torch.envs.game_2048 import Game2048Env
from lightzero_tpu_torch.envs.pendulum import PendulumEnv
from lightzero_tpu_torch.envs.breakout_grid import BreakoutGridEnv
from lightzero_tpu_torch.envs.minatar_like import (
    AsterixGridEnv,
    FreewayGridEnv,
    SeaquestGridEnv,
    SpaceInvadersGridEnv,
)
