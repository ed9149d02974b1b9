"""Locality identities: the port's copy of ``LocalityTier`` and
``TieredIdentity`` from ``alluxio_tpu/utils/wire.py``, as plain
dataclasses (the port does not speak the JAX package's wire codec)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class LocalityTier:
    """One (tier-name, value) locality pair, e.g. ("slice", "slice-0")."""

    tier: str = ""
    value: str = ""


#: Ordered tier names, closest first.
LOCALITY_ORDER = ("host", "slice", "pod", "region")


@dataclass
class TieredIdentity:
    """Ordered locality identity; :meth:`value` looks up one tier."""

    tiers: List[LocalityTier] = field(default_factory=list)

    def value(self, tier: str) -> Optional[str]:
        for t in self.tiers:
            if t.tier == tier:
                return t.value
        return None
