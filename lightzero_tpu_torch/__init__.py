"""PyTorch/CUDA port of ``lightzero_tpu``.

The package mirrors the JAX package's module names so that each ported part
sits where its counterpart does (``search/puct.py`` beside
``lightzero_tpu/search/puct.py``). It imports ``torch``, ``numpy`` and the
standard library only. The TPU kernel of the pUCT descent is a hand-written
CUDA kernel for Hopper (``csrc/fused_traverse.cu``), compiled with ``nvcc``
at first use into ``_build/`` and loaded with ``ctypes``; the replay
buffer's core (``csrc/replay_core.cpp``) is built the same way with g++.
``_build.py`` builds every native source and is the one boundary to it.

Entry points (``MuZeroPolicy``, ``Evaluator``, ``RolloutCollector``,
``batch_puct_search``, ``entry.train_muzero``) run on ``cuda`` unless the
caller passes ``device="cpu"``; with no GPU and no explicit CPU request they
raise.
"""
