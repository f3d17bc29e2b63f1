from lightzero_tpu_torch.buffers.game_buffer import EpisodeRecord, GameBuffer
