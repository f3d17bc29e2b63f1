from lightzero_tpu_torch.envs.board.connect4 import Connect4Env
from lightzero_tpu_torch.envs.board.tictactoe import TicTacToeEnv
