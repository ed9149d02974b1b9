"""YARN deploy integration: run an alluxio-tpu cluster as a YARN app (a
copy of ``alluxio_tpu/yarn/__init__.py``; the application master's
containers launch the port's roles through its shell, ``am.py``).

Env-adapted analogue of the reference's ``integration/yarn`` module
(``Client.java:96``, ``ApplicationMaster.java``,
``ContainerAllocator.java:39`` and the command assembly): a submission
client speaking the ResourceManager REST API (stdlib-only, like every
other connector in this repo), a deterministic round-based container
allocator, and an application-master loop that launches this repo's
own master/worker processes inside the granted containers.

Departure from the reference, written down: the reference negotiates
containers through the asynchronous ``AMRMClientAsync`` protobuf
protocol; here allocation runs as synchronous request/offer rounds
against an injectable RM interface (`` RmProtocol``). The rounds are
semantically the same negotiation (per-host caps, release of excess
offers, bounded attempts) but deterministic — testable without a YARN
cluster, and driven over REST where a real one exists.
"""

from alluxio_tpu_torch.yarn.allocator import (  # noqa: F401
    Container, ContainerAllocator, NotEnoughHostsError,
)
from alluxio_tpu_torch.yarn.client import YarnRestClient  # noqa: F401
from alluxio_tpu_torch.yarn.am import ApplicationMaster, ClusterSpec  # noqa: F401
