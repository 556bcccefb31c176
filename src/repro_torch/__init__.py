"""PyTorch / CUDA port of the ``repro`` package for NVIDIA Hopper (H100).

The package mirrors ``src/repro``'s module layout. It imports ``torch``,
numpy and the standard library only: never ``jax`` and never ``repro``.
Entry points take ``device=`` (default ``"cuda"``) and raise without a card
unless the caller asks for ``"cpu"``.
"""

__version__ = "0.1.0"
