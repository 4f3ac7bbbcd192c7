"""The batch-native optimizer loop."""

from .loop import optimize_from_acc

__all__ = ["optimize_from_acc"]
