"""Plain PyTorch reference of the benchmark's models and train step.

It imports neither the program under test nor the JAX package: only
torch, numpy and its own modules.
"""
