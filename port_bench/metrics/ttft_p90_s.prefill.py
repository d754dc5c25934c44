"""90th percentile of the time to first token (``Request.first_token_at -
Request.submitted_at``) over the window's requests. In the saturating
closed loop it is set by the chunk's time and the request's place in the
engine's sweep, in steps of one chunk: a per-layer reading, not a bound."""
from port_bench import readers


def read(rec):
    return readers.percentile(rec.get("layer", {}).get("ttfts"), 90)
