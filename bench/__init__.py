"""Benchmark of the PyTorch + CUDA miner; the entry point is ``run.py``."""
