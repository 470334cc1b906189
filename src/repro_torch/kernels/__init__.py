"""Hand-written CUDA kernels for Hopper (sources in ``repro_torch/csrc``),
their wrappers, plain PyTorch versions (``ref.py``) and the dispatch
(``ops.py``). Nothing is built at import."""
