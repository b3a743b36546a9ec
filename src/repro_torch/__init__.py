"""PyTorch/CUDA port of the BLCO sparse MTTKRP system.

The package mirrors the JAX package ``repro`` module for module (``core``,
``kernels``, ``engine``) and imports neither it nor JAX.  Entry points put
their tensors on the card (``device="cuda"``) unless the caller passes
``device="cpu"``, which runs the plain PyTorch versions of the kernels.
"""
