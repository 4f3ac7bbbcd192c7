"""Step proposal and the LM damping schedule."""
