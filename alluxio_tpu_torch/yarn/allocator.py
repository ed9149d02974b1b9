"""Round-based YARN container allocator with per-host caps (a copy of
``alluxio_tpu/yarn/allocator.py``).

Mirrors the negotiation contract of the reference's
``ContainerAllocator.java:39``: request the shortfall each round,
accept offers only while the per-host cap and the global target hold,
release every excess offer back to the RM, fail fast when the cluster
cannot possibly satisfy the request, and give up after a bounded
number of rounds (``MAX_WORKER_CONTAINER_REQUEST_ATTEMPTS = 20`` in
the reference, same default here).
"""

from __future__ import annotations

import logging
from collections import Counter
from dataclasses import dataclass
from typing import List, Optional, Protocol, Sequence

logger = logging.getLogger(__name__)

MAX_REQUEST_ATTEMPTS = 20

#: the reference's magic preferred-host value that relaxes locality
#: (``ContainerAllocator.java`` requestContainers: ``"any"``)
ANY_HOST = "any"


class NotEnoughHostsError(RuntimeError):
    """The cluster cannot satisfy the request even in principle
    (hosts x max_per_host < needed) — reference
    ``ExceptionMessage.YARN_NOT_ENOUGH_HOSTS``."""


class AllocationFailedError(RuntimeError):
    """Attempts exhausted before reaching the target count."""


@dataclass(frozen=True)
class Container:
    """A granted container (reference ``Container``: id + node host)."""

    container_id: str
    host: str


class RmProtocol(Protocol):
    """What the allocator needs from a ResourceManager.

    ``request_containers`` is one negotiation round: ask for ``count``
    containers constrained to ``hosts`` (empty = anywhere) and return
    the offers the RM made this round — possibly fewer, more, or on
    capped hosts; the allocator filters. ``release`` hands an excess
    offer back.
    """

    def node_hosts(self) -> Sequence[str]: ...

    def request_containers(self, count: int, hosts: Sequence[str],
                           relax_locality: bool, *,
                           memory_mb: int = 1024,
                           vcores: int = 1) -> Sequence[Container]: ...

    def release(self, container_id: str) -> None: ...


class ContainerAllocator:
    """Negotiate ``target`` containers, at most ``max_per_host`` on any
    single host; ``preferred_host`` pins every request to one host
    (``ANY_HOST`` keeps the pin but relaxes locality, as the reference
    does for masters that may float)."""

    def __init__(self, name: str, target: int, max_per_host: int,
                 rm: RmProtocol, preferred_host: Optional[str] = None,
                 max_attempts: int = MAX_REQUEST_ATTEMPTS,
                 memory_mb: int = 1024, vcores: int = 1) -> None:
        self._name = name
        self._target = target
        self._max_per_host = max_per_host
        self._rm = rm
        self._preferred_host = preferred_host
        self._max_attempts = max_attempts
        self._memory_mb = memory_mb
        self._vcores = vcores
        self._per_host: Counter = Counter()
        self._allocated: List[Container] = []

    # -- offer filtering (reference allocateContainer) ----------------
    def offer(self, container: Container) -> bool:
        """Accept or release one RM offer; returns True if kept."""
        if (self._per_host[container.host] < self._max_per_host
                and len(self._allocated) < self._target):
            self._per_host[container.host] += 1
            self._allocated.append(container)
            return True
        logger.info("releasing excess %s container on host %s",
                    self._name, container.host)
        self._rm.release(container.container_id)
        return False

    def _request_hosts(self) -> tuple:
        if self._preferred_host is not None:
            return ([self._preferred_host],
                    self._preferred_host == ANY_HOST)
        # hosts that still have per-host headroom
        hosts = [h for h in self._rm.node_hosts()
                 if self._per_host[h] < self._max_per_host]
        return hosts, True

    def allocate(self) -> List[Container]:
        for attempt in range(self._max_attempts):
            needed = self._target - len(self._allocated)
            if needed == 0:
                break
            hosts, relax = self._request_hosts()
            if self._preferred_host is None and \
                    len(hosts) * self._max_per_host < needed:
                raise NotEnoughHostsError(
                    f"need {needed} more {self._name} containers but "
                    f"only {len(hosts)} hosts have headroom at "
                    f"{self._max_per_host}/host")
            logger.debug("attempt %d: requesting %d %s containers on "
                         "%d hosts", attempt, needed, self._name,
                         len(hosts))
            for c in self._rm.request_containers(
                    needed, hosts, relax, memory_mb=self._memory_mb,
                    vcores=self._vcores):
                self.offer(c)
        if len(self._allocated) != self._target:
            raise AllocationFailedError(
                f"failed to allocate {self._target} {self._name} "
                f"containers after {self._max_attempts} attempts "
                f"(got {len(self._allocated)})")
        return list(self._allocated)

    @property
    def allocated(self) -> List[Container]:
        return list(self._allocated)
