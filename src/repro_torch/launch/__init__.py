"""Entry points that drive the model: serving steps and ``generate``."""
