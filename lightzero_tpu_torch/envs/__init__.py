from lightzero_tpu_torch.envs.base import EnvStep, TensorEnv
from lightzero_tpu_torch.envs.cartpole import CartPoleEnv
