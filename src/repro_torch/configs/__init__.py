"""Architecture configs: ``base`` holds the dataclasses and the registry,
one module per architecture exposes ``CONFIG``."""
