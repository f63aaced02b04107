"""Layers of the dense transformer, on torch tensors."""
