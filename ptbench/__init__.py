"""The benchmark of ``pathtrace_tpu_torch``, the PyTorch and CUDA renderer:
``python3 ptbench/run.py`` runs one cell (see ``ptbench/README.md``)."""
