"""Command-line shells (a copy of ``alluxio_tpu/shell``).

Re-design of the reference's CLI layer (``shell/src/main/java/alluxio/cli``):
``fs`` (FileSystemShell, ~45 commands), ``fsadmin`` (FileSystemAdminShell),
``job`` (JobShell), ``table``, the validators, ``runOperation`` and
``format``, plus the four role launchers. Dispatch lives in
``alluxio_tpu_torch.shell.main`` (the ``bin/alluxio`` equivalent),
which dispatches every command of the JAX package's shell. No shell
module loads torch.
"""

from alluxio_tpu_torch.shell.command import Command, CommandError, ShellContext

__all__ = ["Command", "CommandError", "ShellContext"]
