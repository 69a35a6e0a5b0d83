"""Single-device training: the optimizers, the train step and loop, the
synthetic data and the checkpoints of the JAX package's ``training``."""
