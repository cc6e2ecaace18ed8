"""Plain PyTorch reference of RIDERS' served chain in float32.

It imports torch, numpy and its own modules only: nothing of the system
under test, and no JAX.
"""
