from lightzero_tpu_torch.reward_model.rnd import RNDNet, RNDRewardModel, RNDState
