"""The decision stack. Ported so far: the wireless channel model."""
from repro_torch.core import channel  # noqa: F401
