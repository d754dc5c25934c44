"""Mean device ms of a local epoch's server stage (the port's split-step
``mark`` hook, CUDA events: from the start of the server stage to the start
of the device backward), over every epoch of the window."""


def read(rec):
    stages = rec.get("layer", {}).get("stage_ms")
    if not stages:
        return None
    return sum(s["server"] for s in stages) / len(stages)
