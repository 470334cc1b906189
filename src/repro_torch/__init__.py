"""PyTorch / CUDA port of the FFTrainer reproduction, for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``configs``, ``models``, ``kernels``, ``train``, ``launch``) and imports
nothing of it. Slice 1 serves the dense decoder (prefill + greedy KV-cache
decode) with two hand-written CUDA kernels:

    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    model = build_model(get_arch("qwen3-0.6b"))          # on CUDA

Importing this package builds nothing: the kernels are compiled with
``nvcc`` at their first launch (``repro_torch.kernels._build``).
"""
