"""STrajNet in PyTorch for NVIDIA Hopper, ported from ``strajnet_tpu``.

The JAX package beside this one is the reference: every module here has a
counterpart of the same name there and is tested against it on the CPU.
Plain tensor code is PyTorch; the TPU's Pallas kernels become CUDA kernels
written for ``sm_90a`` under ``csrc/``, each with a plain PyTorch version that
CPU tensors take and a launch counter.

- ``config``    the dataclass tree of model, loss, train and task settings
- ``ops``       the fused Swin-block kernels (forward and backward), the warp
                gather kernels, window helpers, attention, upconv, dropout
- ``core``      bilinear sampling and the flow warp
- ``models``    Swin encoder, FG-MSA, TrajNet fusion, pyramid decoder, STrajNet
- ``objective`` the 4-term loss, LR schedules, waypoint slicing
- ``train``     Keras Nadam, the train state, the train and predict steps
- ``data``      synthetic batches, the TFRecord schema and host pipeline
- ``infer``     batch inference and the challenge submission writer
- ``interop``   Flax parameter trees and Nadam state -> ``state_dict``

This package imports no JAX, Flax or optax and nothing of ``strajnet_tpu``:
it keeps its own copy of every module it needs. Only the tests import both.
"""

__version__ = "0.2.0"
