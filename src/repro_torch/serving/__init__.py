"""Multi-tenant serving: engine, adapter bank, channel-aware admission."""
from repro_torch.serving.admission import ChannelAdmissionController  # noqa: F401
from repro_torch.serving.engine import (AdapterBank, Request,  # noqa: F401
                                        ServingEngine)
