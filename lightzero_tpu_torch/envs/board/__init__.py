from lightzero_tpu_torch.envs.board.chess import ChessEnv
from lightzero_tpu_torch.envs.board.connect4 import Connect4Env
from lightzero_tpu_torch.envs.board.go import GoEnv
from lightzero_tpu_torch.envs.board.gomoku import GomokuEnv
from lightzero_tpu_torch.envs.board.tictactoe import TicTacToeEnv
