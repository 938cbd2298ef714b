"""Multi-device training over ``torch.distributed``: cameras over the
"data" ranks, image strips over the "tile" ranks, the per-Gaussian
preprocess over the primitive shards, exact strip SSIM, and optionally the
parameters and Adam moments sharded over every rank.

Counterpart of ``frosting_tpu/parallel/``. ``python -m
frosting_tpu_torch.parallel`` (under ``torchrun``) runs one sharded 3DGS
step and one sharded Frosting step on a mesh of any size.
"""
