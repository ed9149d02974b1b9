"""Shell command framework.

A copy of ``alluxio_tpu/shell/command.py``.

Re-design of ``shell/src/main/java/alluxio/cli/{Command,AbstractShell}.java``:
a command registry per shell, argparse-based per-command options, and a
lazily-built client context so `help` works without a running cluster.
"""

from __future__ import annotations

import argparse
import fnmatch
import sys
from typing import Callable, Dict, List, Optional, TextIO

from alluxio_tpu_torch.conf import Configuration, Keys
from alluxio_tpu_torch.utils.exceptions import AlluxioTpuError
from alluxio_tpu_torch.utils.wire import FileInfo


class CommandError(Exception):
    """User-facing command failure (maps to exit code 1, message on stderr)."""


class ShellContext:
    """Lazily-constructed clients shared by every command in one invocation."""

    def __init__(self, conf: Optional[Configuration] = None,
                 out: Optional[TextIO] = None,
                 err: Optional[TextIO] = None) -> None:
        self.conf = conf or Configuration()
        # Late-bound: a default-constructed context must follow RUNTIME
        # sys.stdout/sys.stderr swaps (capsys, supervisors), not whatever
        # the streams were at import time.
        self._out = out
        self._err = err
        self._fs = None
        self._fs_client = None
        self._block_client = None
        self._meta_client = None
        self._job_client = None
        self._table_client = None

    @property
    def out(self) -> TextIO:
        return self._out if self._out is not None else sys.stdout

    @out.setter
    def out(self, stream: Optional[TextIO]) -> None:
        self._out = stream

    @property
    def err(self) -> TextIO:
        return self._err if self._err is not None else sys.stderr

    @err.setter
    def err(self, stream: Optional[TextIO]) -> None:
        self._err = stream

    @property
    def master_address(self) -> str:
        addresses = self.conf.get(Keys.MASTER_RPC_ADDRESSES)
        if addresses:
            return str(addresses)
        return (f"{self.conf.get(Keys.MASTER_HOSTNAME)}:"
                f"{self.conf.get_int(Keys.MASTER_RPC_PORT)}")

    @property
    def job_master_address(self) -> str:
        return (f"{self.conf.get(Keys.JOB_MASTER_HOSTNAME)}:"
                f"{self.conf.get_int(Keys.JOB_MASTER_RPC_PORT)}")

    def fs(self):
        if self._fs is None:
            from alluxio_tpu_torch.client.file_system import FileSystem

            self._fs = FileSystem(self.master_address, conf=self.conf)
        return self._fs

    def fs_client(self):
        if self._fs_client is None:
            from alluxio_tpu_torch.rpc.clients import FsMasterClient

            self._fs_client = FsMasterClient(self.master_address,
                                             conf=self.conf)
        return self._fs_client

    def block_client(self):
        if self._block_client is None:
            from alluxio_tpu_torch.rpc.clients import BlockMasterClient

            self._block_client = BlockMasterClient(self.master_address,
                                                   conf=self.conf)
        return self._block_client

    def meta_client(self):
        if self._meta_client is None:
            from alluxio_tpu_torch.rpc.clients import MetaMasterClient

            self._meta_client = MetaMasterClient(self.master_address,
                                                 conf=self.conf)
        return self._meta_client

    def job_client(self):
        if self._job_client is None:
            from alluxio_tpu_torch.rpc.job_service import JobMasterClient

            self._job_client = JobMasterClient(self.job_master_address,
                                               conf=self.conf)
        return self._job_client

    def table_client(self):
        if self._table_client is None:
            from alluxio_tpu_torch.rpc.table_service import TableMasterClient

            self._table_client = TableMasterClient(self.master_address,
                                                   conf=self.conf)
        return self._table_client

    def close(self) -> None:
        if self._fs is not None:
            self._fs.close()

    # -- output helpers ------------------------------------------------------
    def print(self, *args) -> None:
        print(*args, file=self.out)

    def eprint(self, *args) -> None:
        print(*args, file=self.err)


class Command:
    """One shell command. Subclasses set ``name``/``usage``/``description``,
    add options in ``configure(parser)`` and implement ``run(args, ctx)``."""

    name: str = ""
    usage: str = ""
    description: str = ""

    def configure(self, parser: argparse.ArgumentParser) -> None:  # noqa: B027
        pass

    def run(self, args: argparse.Namespace, ctx: ShellContext) -> int:
        raise NotImplementedError

    def make_parser(self, prog_prefix: str) -> argparse.ArgumentParser:
        # resolve conflicts so command flags like ls -h (human sizes) win
        # over argparse's auto -h/--help (--help still works)
        p = argparse.ArgumentParser(
            prog=f"{prog_prefix} {self.name}", description=self.description,
            conflict_handler="resolve")
        self.configure(p)
        return p


class Shell:
    """A named shell = registry of commands + a dispatch loop
    (reference: ``AbstractShell.run``)."""

    def __init__(self, name: str, description: str = "") -> None:
        self.name = name
        self.description = description
        self.commands: Dict[str, Command] = {}

    def register(self, cmd_cls: type) -> type:
        cmd = cmd_cls()
        self.commands[cmd.name] = cmd
        return cmd_cls

    def print_usage(self, ctx: ShellContext) -> None:
        ctx.print(f"Usage: alluxio-tpu {self.name} [generic options] "
                  f"<command> [command options]")
        ctx.print(f"\n{self.description}\nCommands:")
        for name in sorted(self.commands):
            c = self.commands[name]
            ctx.print(f"  {name:<22s} {c.description}")

    def run(self, argv: List[str], ctx: Optional[ShellContext] = None) -> int:
        ctx = ctx or ShellContext()
        if not argv or argv[0] in ("help", "-h", "--help"):
            if len(argv) > 1 and argv[1] in self.commands:
                self.commands[argv[1]].make_parser(
                    f"alluxio-tpu {self.name}").print_help(ctx.out)
                return 0
            self.print_usage(ctx)
            return 0
        name, rest = argv[0], argv[1:]
        cmd = self.commands.get(name)
        if cmd is None:
            ctx.eprint(f"{name} is not a valid command.")
            self.print_usage(ctx)
            return 1
        parser = cmd.make_parser(f"alluxio-tpu {self.name}")
        try:
            args = parser.parse_args(rest)
        except SystemExit as e:
            return int(e.code or 0)
        try:
            return cmd.run(args, ctx) or 0
        except CommandError as e:
            ctx.eprint(str(e))
            return 1
        except AlluxioTpuError as e:
            ctx.eprint(f"{type(e).__name__}: {e}")
            return 1
        finally:
            ctx.close()


# -- shared formatting helpers (reference: FileSystemShellUtils) -------------

def human_size(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB", "PB"):
        if abs(n) < 1024 or unit == "PB":
            return f"{n:.2f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024
    return f"{n:.2f}PB"


_SPARK_BLOCKS = "▁▂▃▄▅▆▇█"


def sparkline(values, width: int = 60) -> str:
    """ASCII(ish) sparkline of a numeric series, last ``width`` points
    (`fsadmin report history`).  Flat series render as a low bar, not a
    divide-by-zero."""
    vals = [float(v) for v in values][-width:]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    span = hi - lo
    if span <= 0:
        return _SPARK_BLOCKS[0] * len(vals)
    top = len(_SPARK_BLOCKS) - 1
    return "".join(_SPARK_BLOCKS[int(round((v - lo) / span * top))]
                   for v in vals)


def mode_string(info: FileInfo) -> str:
    kind = "d" if info.folder else "-"
    bits = ""
    for shift in (6, 3, 0):
        trio = (info.mode >> shift) & 7
        bits += ("r" if trio & 4 else "-") + ("w" if trio & 2 else "-") + \
            ("x" if trio & 1 else "-")
    return kind + bits


def format_ls_line(info: FileInfo, human: bool = False) -> str:
    import datetime

    size = human_size(info.length) if human else str(info.length)
    when = datetime.datetime.fromtimestamp(
        info.last_modification_time_ms / 1000.0
    ).strftime("%m-%d-%Y %H:%M:%S")
    state = info.persistence_state
    return (f"{mode_string(info)} {info.owner or '-':<10s} "
            f"{info.group or '-':<10s} {size:>12s} {state:<14s} {when} "
            f"{'DIR' if info.folder else f'{info.in_memory_percentage}%':>4s} "
            f"{info.path}")


def expand_globs(fs, path: str) -> List[str]:
    """Expand a trailing-component glob (``/a/b*``) against the namespace
    (reference: FileSystemShellUtils.getAlluxioURIs)."""
    if not any(ch in path for ch in "*?[]"):
        return [path]
    from alluxio_tpu_torch.utils.uri import AlluxioURI

    uri = AlluxioURI(path)
    parent = uri.parent()
    if parent is None:
        return [path]
    matches = [i.path for i in fs.list_status(parent.path)
               if fnmatch.fnmatch(i.path.rsplit("/", 1)[-1], uri.name)]
    if not matches:
        raise CommandError(f"{path} does not match any file or directory")
    return sorted(matches)
