"""Package setup (reference analog: setup.py)."""

from setuptools import find_packages, setup

setup(
    name="mvsnet_tpu",
    version="0.1.0",
    description="TPU-native multi-view stereo framework (MVSNet / R-MVSNet)",
    packages=find_packages(include=["mvsnet_tpu", "mvsnet_tpu.*",
                                    "mvsnet_tpu_torch", "mvsnet_tpu_torch.*"]),
    # the PyTorch/CUDA port builds its kernels and native libraries from these
    # sources at first use; its scripts/ holds two shell drivers
    package_data={"mvsnet_tpu_torch": ["csrc/*.cu", "csrc/*.cuh", "native/*.cpp",
                                       "scripts/*.sh"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "optax",
        "orbax-checkpoint",
        "numpy",
        "imageio",
        "opencv-python",
    ],
    extras_require={
        "tools": ["boto3", "requests", "matplotlib"],
        "test": ["pytest"],
    },
)
