"""Entry points: serving steps and ``generate``, training, calibration, and
the fleet simulator's drivers."""
import json


def write_payload(path: str, payload) -> None:
    """Write a driver's JSON payload (indented, keys sorted) to ``path``."""
    with open(path, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {path}")
