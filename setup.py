"""Packaging (counterpart of the reference's setup.py, minus nvcc: the TPU
kernels are JIT-compiled by Mosaic at run time, so there is no ahead-of-
time native build step for the compute path; the native data loader builds
itself on first use with g++)."""

from setuptools import find_packages, setup

exec(open("flash_cosine_sim_attention_tpu/version.py").read())

setup(
    name="flash-cosine-sim-attention-tpu",
    version=__version__,  # noqa: F821
    description=(
        "TPU-native fused cosine-similarity flash attention "
        "(JAX / Pallas / pjit): no-row-max streaming softmax kernels, "
        "INT8 KV-cache decode, head-sharded and ring-parallel scaling"
    ),
    packages=find_packages(exclude=("tests",)),
    include_package_data=True,
    # the PyTorch port's CUDA sources, compiled with nvcc at first use
    package_data={"flash_cosine_sim_attention_tpu_torch": ["csrc/*.cu",
                                                       "csrc/*.cuh"]},
    data_files=[("native", ["native/dataloader.cc"])],
    python_requires=">=3.10",
    install_requires=[
        "jax>=0.4.30",
        "flax>=0.8",
        "optax>=0.2",
        "numpy",
    ],
    extras_require={
        "train": ["orbax-checkpoint"],
        "test": ["pytest"],
        "torch": ["torch>=2.4"],
    },
)
