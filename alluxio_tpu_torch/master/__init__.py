"""Master control plane (reference: ``core/server/master``)."""

from alluxio_tpu_torch.master.block_master import BlockMaster, WorkerCommand  # noqa: F401
from alluxio_tpu_torch.master.file_master import FileSystemMaster  # noqa: F401
from alluxio_tpu_torch.master.inode import Inode, PersistenceState, TtlAction  # noqa: F401
from alluxio_tpu_torch.master.inode_tree import InodeTree  # noqa: F401
from alluxio_tpu_torch.master.mount_table import MountInfo, MountTable  # noqa: F401
