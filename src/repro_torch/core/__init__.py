"""The decision stack (channel, hardware, cost model, CARD, measured cost)
and the SL computation (splitting, faults, the protocol)."""
from repro_torch.core import channel  # noqa: F401
