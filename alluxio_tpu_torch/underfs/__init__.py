"""Under-filesystems: the local UFS and the mount-id-keyed manager (a copy
of the part of ``alluxio_tpu/underfs`` the worker's cold reads use)."""
