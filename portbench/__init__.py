"""The benchmark of the PyTorch/CUDA port (``portbench/run.py``)."""
