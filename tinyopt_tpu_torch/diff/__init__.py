"""Automatic differentiation on the tangent space (torch.func)."""
