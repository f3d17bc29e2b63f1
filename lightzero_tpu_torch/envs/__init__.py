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
from lightzero_tpu_torch.envs.board import ChessEnv, Connect4Env, GoEnv, GomokuEnv, TicTacToeEnv
from lightzero_tpu_torch.envs.bsuite_like import CatchEnv, DeepSeaEnv
from lightzero_tpu_torch.envs.memory_env import MemoryEnv
from lightzero_tpu_torch.envs.wrappers import DiscretizeAction, PadVectorObs
