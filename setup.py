"""Package metadata (reference: setup.py packaging the vsrlab package)."""
from setuptools import find_packages, setup

setup(
    name="vsrlab_tpu",
    version="0.1.0",
    description=(
        "TPU-native (JAX/XLA) video super-resolution framework: model zoo, "
        "optical flow, SPMD training, evaluation harness"
    ),
    packages=find_packages(
        include=["vsrlab_tpu", "vsrlab_tpu.*", "vsrlab_tpu_torch", "vsrlab_tpu_torch.*"]
    ),
    python_requires=">=3.10",
    install_requires=["jax", "flax", "optax", "orbax-checkpoint", "numpy", "pyyaml"],
    extras_require={"data": ["opencv-python"], "logging": ["wandb"], "eval": ["pandas"]},
)
