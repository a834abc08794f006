"""Finetune entry point, eval loop, fast-path policy and weight carry-over
from the JAX package."""
