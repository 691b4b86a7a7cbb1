"""PyTorch walkthroughs of ``kissabc_tpu_torch``, one per JAX example of
``examples/``, with the same file names.

Each runs on CUDA (``python examples_torch/example_n1.py``) and raises
without a card; ``--device cpu`` (or ``main(device="cpu")``) runs it on
the CPU through the kernels' plain versions.
"""
