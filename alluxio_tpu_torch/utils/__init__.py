"""Foundation utilities (a copy of ``alluxio_tpu/utils``; reference:
``core/base`` + ``core/common/util``)."""

from alluxio_tpu_torch.utils.uri import AlluxioURI  # noqa: F401
from alluxio_tpu_torch.utils import exceptions  # noqa: F401
