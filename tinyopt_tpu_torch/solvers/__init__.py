"""Step proposal and the LM damping schedule."""

from .lm import LMState, lm_bad_step, lm_failed_step, lm_good_step, lm_init
from .step import propose_step

__all__ = ["LMState", "lm_init", "lm_good_step", "lm_bad_step",
           "lm_failed_step", "propose_step"]
