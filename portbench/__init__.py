"""The benchmark of legkilo_torch, the PyTorch/CUDA port: Monte-Carlo fleets
on one H100 (BENCHMARK.json at the root of the repo names its cells and
metrics; ``python portbench/run.py`` runs one cell once).  Nothing here
imports JAX or the JAX package."""
