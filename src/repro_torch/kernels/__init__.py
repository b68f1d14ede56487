"""Hand-written CUDA kernels of the port, one package per reference kernel,
each with its plain PyTorch version (`ref.py`) and wrapper (`ops.py`)."""
