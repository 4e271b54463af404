"""PyTorch/CUDA port of the ``repro`` package for NVIDIA Hopper GPUs.

Module paths mirror ``repro``: ``repro_torch.models.model`` is the
counterpart of ``repro.models.model``, and so on.  The port imports
neither JAX nor ``repro``; what it needs of host-only modules it keeps
as its own copy.  Entry points run on the GPU unless the caller passes
``device="cpu"``.
"""
