"""Part of the PyTorch/CUDA port (see oversim_tpu_torch/__init__.py)."""
