"""vitiq — a JAX (XLA/Pallas) framework for automatic modulation
classification on raw I/Q frames, run on NVIDIA GPUs.

Re-implements the full capability surface of the
`aliftffd/ViT-vs-Raw-IQ` thesis codebase (reference mounted read-only at
/root/reference/Transformer_Thesis): two transformer arms over RadioML
2018.01A-style I/Q data —

  * ViT arm: z-score normalize I/Q, concat to a 2048-vector, view as a
    [1, 32, 64] "image", patchify, CLS-token transformer encoder
    (ref: ViT/dataloader/dataset.py:211-226, ViT/models/amc_transformer.py:5-31)
  * raw-IQ arm: keep the [2, 1024] sequence, tokenize by pointwise conv or
    segment folding, same shared encoder core
    (ref: transformer_rawIQ/models/transformer_rawIQ.py:7-97)

plus the DSP front-end (RRC / matched filter / timing recovery), deterministic
HDF5 data layer, jitted training loop, SNR-sliced evaluation, cross-arm
comparison, PSO sweep harness, and benchmark suite.

Unlike the reference (single-GPU PyTorch, two copy-pasted trees), this package
has ONE shared encoder core, pure-functional models compiled under `jit`,
data-parallel + tensor-parallel sharding over a `jax.sharding.Mesh`, and Pallas
kernels for the hot paths.
"""

__version__ = "0.1.0"

from vitiq.config import (  # noqa: F401
    DataConfig,
    ExperimentConfig,
    ModelConfig,
    TrainConfig,
    TARGET_MODULATIONS_19,
)
