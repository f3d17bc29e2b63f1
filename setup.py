"""Packaging (role of the reference setup.py; no native extensions needed —
the compute path is JAX/XLA, see README)."""
from setuptools import find_packages, setup

setup(
    name="lightzero_tpu",
    version="0.1.0",
    description="TPU-native MCTS+RL framework (LightZero capability surface, JAX/XLA)",
    # lightzero_tpu_torch: the PyTorch/CUDA port; its CUDA sources are
    # compiled with nvcc, its host C++ with g++, at first use
    # (lightzero_tpu_torch/_build.py)
    packages=find_packages(
        include=["lightzero_tpu", "lightzero_tpu.*", "lightzero_tpu_torch", "lightzero_tpu_torch.*"]
    ),
    package_data={"lightzero_tpu_torch": ["csrc/*.cu", "csrc/*.cpp"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "optax",
        "orbax-checkpoint",
        "numpy",
    ],
    extras_require={
        "envs": ["gymnasium"],
        "atari": ["gymnasium", "ale-py"],
        "dev": ["pytest"],
    },
)
