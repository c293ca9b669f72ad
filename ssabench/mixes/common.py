"""What the mixes share: the port's enums by name, and the comparison's
numbers with their limits."""
from __future__ import annotations


def enum(cls, name: str):
    """The member of one of the port's enums that a traffic file names."""
    return cls[name.upper()]


def numbers(values: dict, limits: dict) -> dict:
    """``{name: {"value": v, "limit": limit}}`` for every compared number;
    a number the traffic file gives no limit raises."""
    missing = set(values) - set(limits)
    if missing:
        raise KeyError(f"no limit for {sorted(missing)}")
    return {k: {"value": getattr(v, "item", lambda: v)(), "limit": limits[k]}
            for k, v in values.items()}
