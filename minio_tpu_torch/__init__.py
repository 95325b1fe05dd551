"""minio_tpu_torch: the PyTorch/CUDA port of minio_tpu.

The erasure-coded object data plane (object layer -> erasure streaming
-> codec backend -> fused codec steps) and S3 Select's device scan, with
their device work written as hand-made CUDA kernels for Hopper
(``csrc/codec.cu``, bound in ``ops/kernels.py``; ``csrc/select.cu``,
bound in ``ops/select_step.py``).  Every kernel has a plain PyTorch twin that runs
only for CPU tensors; entry points take an explicit ``device`` and
default to the card.
"""
