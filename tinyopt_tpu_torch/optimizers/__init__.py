"""The batch-native optimizer loop."""
