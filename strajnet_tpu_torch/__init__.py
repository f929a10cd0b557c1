"""STrajNet in PyTorch for NVIDIA Hopper, ported from ``strajnet_tpu``.

The JAX package beside this one is the reference: every module here has a
counterpart of the same name there and is tested against it on the CPU.
Plain tensor code is PyTorch; the TPU's Pallas kernels become CUDA kernels
written for ``sm_90a`` under ``csrc/``, each with a plain PyTorch version that
CPU tensors take and a launch counter.

- ``ops``       window helpers, the fused Swin-block kernel, attention, upconv
- ``core``      bilinear sampling
- ``models``    Swin encoder, FG-MSA, TrajNet fusion, pyramid decoder, STrajNet
- ``interop``   Flax parameter trees -> ``state_dict``
- ``objective`` waypoint slicing and the occupancy sigmoid
- ``train``     the predict step
- ``infer``     batch inference and the challenge submission writer

This package imports no JAX or Flax; it reuses the framework-free modules
``strajnet_tpu.config``, ``strajnet_tpu.data.synthetic`` and
``strajnet_tpu.infer.{submission,proto}``.
"""

__version__ = "0.1.0"
