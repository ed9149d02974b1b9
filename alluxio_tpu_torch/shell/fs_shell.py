"""FileSystemShell: ``alluxio-tpu fs <command>``.

A copy of ``alluxio_tpu/shell/fs_shell.py``.

Re-design of ``shell/src/main/java/alluxio/cli/fs/FileSystemShell.java`` +
``fs/command/*.java`` — the ~40 user-facing filesystem commands mapped onto
the TPU-native client stack. Distributed variants submit job-service plans
(reference: ``DistributedLoadCommand.java`` et al.).
"""

from __future__ import annotations

import hashlib
import os
import sys
import time

from alluxio_tpu_torch.shell.command import (
    Command, CommandError, Shell, expand_globs, format_ls_line, human_size,
)
from alluxio_tpu_torch.utils.exceptions import NotFoundError
from alluxio_tpu_torch.utils.uri import AlluxioURI

FS_SHELL = Shell("fs", "Interact with the alluxio-tpu file system.")


def _each(fs, args_paths):
    for raw in args_paths:
        for p in expand_globs(fs, raw):
            yield p


_PUMP_CHUNK = 4 << 20


def _pump(fin, fout) -> None:
    """Stream fin -> fout in chunks (both alluxio and local file objects)."""
    while True:
        chunk = fin.read(_PUMP_CHUNK)
        if not chunk:
            break
        fout.write(chunk)


def _walk_files(fs, path):
    """Yield FileInfo of every file under path (path itself if a file)."""
    info = fs.get_status(path)
    if not info.folder:
        yield info
        return
    for i in fs.list_status(path, recursive=True):
        if not i.folder:
            yield i


@FS_SHELL.register
class CatCommand(Command):
    name, description = "cat", "Print the file's contents to stdout."

    def configure(self, p):
        p.add_argument("paths", nargs="+")

    def run(self, args, ctx):
        fs = ctx.fs()
        for p in _each(fs, args.paths):
            with fs.open_file(p) as f:
                while True:
                    chunk = f.read(1 << 20)
                    if not chunk:
                        break
                    ctx.out.write(chunk.decode("utf-8", "replace"))
        return 0


@FS_SHELL.register
class HeadCommand(Command):
    name, description = "head", "Print the first bytes of a file."

    def configure(self, p):
        p.add_argument("-c", type=int, default=1024, dest="num_bytes")
        p.add_argument("path")

    def run(self, args, ctx):
        fs = ctx.fs()
        with fs.open_file(args.path) as f:
            ctx.out.write(f.read(args.num_bytes).decode("utf-8", "replace"))
        return 0


@FS_SHELL.register
class TailCommand(Command):
    name, description = "tail", "Print the last bytes of a file."

    def configure(self, p):
        p.add_argument("-c", type=int, default=1024, dest="num_bytes")
        p.add_argument("path")

    def run(self, args, ctx):
        fs = ctx.fs()
        info = fs.get_status(args.path)
        with fs.open_file(args.path) as f:
            start = max(0, info.length - args.num_bytes)
            ctx.out.write(f.pread(start, info.length - start)
                          .decode("utf-8", "replace"))
        return 0


@FS_SHELL.register
class LsCommand(Command):
    name, description = "ls", "List the directory's (or file's) status."

    def configure(self, p):
        p.add_argument("-R", action="store_true", dest="recursive")
        p.add_argument("-h", action="store_true", dest="human")
        p.add_argument("--sort", default="path",
                       choices=["path", "size", "lastModificationTime"])
        p.add_argument("-r", action="store_true", dest="reverse")
        p.add_argument("-f", action="store_true", dest="force_sync",
                       help="force a metadata sync against the UFS")
        p.add_argument("paths", nargs="+")

    def run(self, args, ctx):
        fs = ctx.fs()
        key = {"path": lambda i: i.path, "size": lambda i: i.length,
               "lastModificationTime":
               lambda i: i.last_modification_time_ms}[args.sort]
        for p in _each(fs, args.paths):
            if args.force_sync:
                fs.fs_master.sync_metadata(p)
            info = fs.get_status(p)
            infos = [info] if not info.folder else fs.list_status(
                p, recursive=args.recursive)
            for i in sorted(infos, key=key, reverse=args.reverse):
                ctx.print(format_ls_line(i, human=args.human))
        return 0


@FS_SHELL.register
class MkdirCommand(Command):
    name, description = "mkdir", "Create directories (with parents)."

    def configure(self, p):
        p.add_argument("paths", nargs="+")

    def run(self, args, ctx):
        fs = ctx.fs()
        for p in args.paths:
            fs.create_directory(p, recursive=True)
            ctx.print(f"Successfully created directory {p}")
        return 0


@FS_SHELL.register
class TouchCommand(Command):
    name, description = "touch", "Create an empty file."

    def configure(self, p):
        p.add_argument("paths", nargs="+")

    def run(self, args, ctx):
        fs = ctx.fs()
        for p in args.paths:
            fs.write_all(p, b"")
            ctx.print(f"{p} has been created")
        return 0


@FS_SHELL.register
class RmCommand(Command):
    name, description = "rm", "Remove files or directories."

    def configure(self, p):
        p.add_argument("-R", action="store_true", dest="recursive")
        p.add_argument("--alluxioOnly", action="store_true",
                       dest="alluxio_only",
                       help="remove only from the cache namespace, not UFS")
        p.add_argument("paths", nargs="+")

    def run(self, args, ctx):
        fs = ctx.fs()
        for p in _each(fs, args.paths):
            fs.delete(p, recursive=args.recursive,
                      alluxio_only=args.alluxio_only)
            ctx.print(f"{p} has been removed")
        return 0


@FS_SHELL.register
class MvCommand(Command):
    name, description = "mv", "Rename a file or directory."

    def configure(self, p):
        p.add_argument("src")
        p.add_argument("dst")

    def run(self, args, ctx):
        ctx.fs().rename(args.src, args.dst)
        ctx.print(f"Renamed {args.src} to {args.dst}")
        return 0


def _resolve_into_dir(fs, src: str, dst: str) -> str:
    """cp semantics: copying INTO an existing directory targets
    dst/<basename(src)>."""
    if fs.exists(dst) and fs.get_status(dst).folder:
        return AlluxioURI(dst).join(AlluxioURI(src).name).path
    return dst


def _copy_tree(fs, src: str, dst: str, ctx) -> None:
    info = fs.get_status(src)
    if info.folder:
        fs.create_directory(dst, recursive=True, allow_exists=True)
        for child in fs.list_status(src):
            _copy_tree(fs, child.path,
                       AlluxioURI(dst).join(child.name).path, ctx)
        return
    with fs.open_file(src) as fin, fs.create_file(dst) as fout:
        _pump(fin, fout)
    ctx.print(f"Copied {src} to {dst}")


@FS_SHELL.register
class CpCommand(Command):
    name = "cp"
    description = "Copy within the namespace, or from/to file:// paths."

    def configure(self, p):
        p.add_argument("-R", action="store_true", dest="recursive")
        p.add_argument("src")
        p.add_argument("dst")

    def run(self, args, ctx):
        fs = ctx.fs()
        src_local = args.src.startswith("file://")
        dst_local = args.dst.startswith("file://")
        if src_local and dst_local:
            raise CommandError("use the system cp for local-to-local copies")
        if src_local:
            _from_local(fs, args.src[len("file://"):], args.dst, ctx)
        elif dst_local:
            _to_local(fs, args.src, args.dst[len("file://"):], ctx)
        else:
            matches = expand_globs(fs, args.src)
            if len(matches) > 1 and not (
                    fs.exists(args.dst) and fs.get_status(args.dst).folder):
                raise CommandError(
                    f"target {args.dst} must be an existing directory when "
                    f"copying multiple sources")
            for p in matches:
                info = fs.get_status(p)
                if info.folder and not args.recursive:
                    raise CommandError(f"{p} is a directory (use -R)")
                _copy_tree(fs, p, _resolve_into_dir(fs, p, args.dst), ctx)
        return 0


def _from_local(fs, local: str, remote: str, ctx) -> None:
    if os.path.isdir(local):
        fs.create_directory(remote, recursive=True, allow_exists=True)
        for name in sorted(os.listdir(local)):
            _from_local(fs, os.path.join(local, name),
                        AlluxioURI(remote).join(name).path, ctx)
        return
    if fs.exists(remote) and fs.get_status(remote).folder:
        remote = AlluxioURI(remote).join(os.path.basename(local)).path
    with open(local, "rb") as fin, fs.create_file(remote) as fout:
        _pump(fin, fout)
    ctx.print(f"Copied file://{local} to {remote}")


def _to_local(fs, remote: str, local: str, ctx) -> None:
    info = fs.get_status(remote)
    if info.folder:
        os.makedirs(local, exist_ok=True)
        for child in fs.list_status(remote):
            _to_local(fs, child.path, os.path.join(local, child.name), ctx)
        return
    if os.path.isdir(local):
        local = os.path.join(local, AlluxioURI(remote).name)
    with fs.open_file(remote) as fin, open(local, "wb") as fout:
        _pump(fin, fout)
    ctx.print(f"Copied {remote} to file://{local}")


@FS_SHELL.register
class CopyFromLocalCommand(Command):
    name = "copyFromLocal"
    description = "Copy a local file/dir into the namespace."

    def configure(self, p):
        p.add_argument("src")
        p.add_argument("dst")

    def run(self, args, ctx):
        _from_local(ctx.fs(), args.src, args.dst, ctx)
        return 0


@FS_SHELL.register
class CopyToLocalCommand(Command):
    name = "copyToLocal"
    description = "Copy a file/dir out to the local filesystem."

    def configure(self, p):
        p.add_argument("src")
        p.add_argument("dst")

    def run(self, args, ctx):
        _to_local(ctx.fs(), args.src, args.dst, ctx)
        return 0


@FS_SHELL.register
class StatCommand(Command):
    name, description = "stat", "Display all metadata of a path."

    def configure(self, p):
        p.add_argument("-f", dest="fmt", default=None,
                       help="format string, e.g. %%z (size) %%u %%g %%Y")
        p.add_argument("path")

    def run(self, args, ctx):
        info = ctx.fs().get_status(args.path)
        if args.fmt:
            out = (args.fmt.replace("%z", str(info.length))
                   .replace("%u", info.owner).replace("%g", info.group)
                   .replace("%y", time.strftime(
                       "%Y-%m-%d %H:%M:%S", time.localtime(
                           info.last_modification_time_ms / 1000)))
                   .replace("%Y", str(info.last_modification_time_ms))
                   .replace("%b", str(len(info.block_ids))))
            ctx.print(out)
            return 0
        for k, v in sorted(info.to_wire().items()):
            ctx.print(f"{k}: {v}")
        return 0


@FS_SHELL.register
class TestCommand(Command):
    name, description = "test", "Test path properties; exit code is 0/1."

    def configure(self, p):
        p.add_argument("-d", action="store_true", dest="is_dir")
        p.add_argument("-f", action="store_true", dest="is_file")
        p.add_argument("-e", action="store_true", dest="exists")
        p.add_argument("-z", action="store_true", dest="zero_len")
        p.add_argument("-s", action="store_true", dest="non_empty_dir")
        p.add_argument("path")

    def run(self, args, ctx):
        fs = ctx.fs()
        try:
            info = fs.get_status(args.path)
        except NotFoundError:
            return 1 if (args.exists or args.is_dir or args.is_file
                         or args.zero_len or args.non_empty_dir) else 0
        if args.is_dir:
            return 0 if info.folder else 1
        if args.is_file:
            return 0 if not info.folder else 1
        if args.zero_len:
            return 0 if (not info.folder and info.length == 0) else 1
        if args.non_empty_dir:
            return 0 if (info.folder and fs.list_status(args.path)) else 1
        return 0


@FS_SHELL.register
class ChecksumCommand(Command):
    name, description = "checksum", "Print the md5 checksum of a file."

    def configure(self, p):
        p.add_argument("paths", nargs="+")

    def run(self, args, ctx):
        fs = ctx.fs()
        for p in _each(fs, args.paths):
            h = hashlib.md5()
            with fs.open_file(p) as f:
                while True:
                    chunk = f.read(4 << 20)
                    if not chunk:
                        break
                    h.update(chunk)
            ctx.print(f"md5sum of {p}: {h.hexdigest()}")
        return 0


@FS_SHELL.register
class CountCommand(Command):
    name = "count"
    description = "Count directories, files and total bytes under a path."

    def configure(self, p):
        p.add_argument("-h", action="store_true", dest="human")
        p.add_argument("path")

    def run(self, args, ctx):
        fs = ctx.fs()
        files = dirs = total = 0
        for i in fs.list_status(args.path, recursive=True):
            if i.folder:
                dirs += 1
            else:
                files += 1
                total += i.length
        size = human_size(total) if args.human else str(total)
        ctx.print(f"{'File Count':>12s} {'Folder Count':>12s} "
                  f"{'Total Bytes':>12s}")
        ctx.print(f"{files:>12d} {dirs:>12d} {size:>12s}")
        return 0


@FS_SHELL.register
class DuCommand(Command):
    name, description = "du", "Show disk usage of files under a path."

    def configure(self, p):
        p.add_argument("-s", action="store_true", dest="summary")
        p.add_argument("-h", action="store_true", dest="human")
        p.add_argument("--memory", action="store_true",
                       help="also show bytes held in worker memory")
        p.add_argument("paths", nargs="+")

    def run(self, args, ctx):
        fs = ctx.fs()
        fmt = human_size if args.human else str
        for p in _each(fs, args.paths):
            total = in_mem = 0
            for i in _walk_files(fs, p):
                size = i.length
                mem = size * i.in_memory_percentage // 100
                total += size
                in_mem += mem
                if not args.summary:
                    line = f"{fmt(size):>12s} "
                    if args.memory:
                        line += f"{fmt(mem):>12s} "
                    ctx.print(line + i.path)
            line = f"{fmt(total):>12s} "
            if args.memory:
                line += f"{fmt(in_mem):>12s} "
            ctx.print(line + p)
        return 0


@FS_SHELL.register
class PinCommand(Command):
    name = "pin"
    description = "Pin a path so its blocks are never evicted."

    def configure(self, p):
        p.add_argument("path")
        p.add_argument("media", nargs="*",
                       help="optional allowed medium types")

    def run(self, args, ctx):
        ctx.fs().set_attribute(args.path, pinned=True,
                               pinned_media=args.media or None)
        ctx.print(f"File {args.path} was successfully pinned")
        return 0


@FS_SHELL.register
class UnpinCommand(Command):
    name, description = "unpin", "Unpin a path."

    def configure(self, p):
        p.add_argument("path")

    def run(self, args, ctx):
        ctx.fs().set_attribute(args.path, pinned=False)
        ctx.print(f"File {args.path} was successfully unpinned")
        return 0


@FS_SHELL.register
class FreeCommand(Command):
    name = "free"
    description = "Evict a path's blocks from worker caches (data stays in UFS)."

    def configure(self, p):
        p.add_argument("-f", action="store_true", dest="forced",
                       help="free even pinned files")
        p.add_argument("path")

    def run(self, args, ctx):
        ctx.fs().free(args.path, recursive=True, forced=args.forced)
        ctx.print(f"{args.path} was successfully freed from memory")
        return 0


@FS_SHELL.register
class LoadCommand(Command):
    name = "load"
    description = "Read a path through the cache so it becomes resident."

    def configure(self, p):
        p.add_argument("--local", action="store_true",
                       help="pull the data to this client's nearest worker")
        p.add_argument("path")

    def run(self, args, ctx):
        fs = ctx.fs()
        for i in _walk_files(fs, args.path):
            with fs.open_file(i.path) as f:
                while f.read(8 << 20):
                    pass
        ctx.print(f"{args.path} loaded")
        return 0


@FS_SHELL.register
class PersistCommand(Command):
    name, description = "persist", "Persist a path to its under storage."

    def configure(self, p):
        p.add_argument("paths", nargs="+")

    def run(self, args, ctx):
        fs = ctx.fs()
        for raw in args.paths:
            for p in expand_globs(fs, raw):
                for i in _walk_files(fs, p):
                    if not i.persisted:
                        fs.persist_now(i.path)
                        ctx.print(f"persisted file {i.path}")
        return 0


@FS_SHELL.register
class SetTtlCommand(Command):
    name, description = "setTtl", "Set time-to-live on a path."

    def configure(self, p):
        p.add_argument("--action", default="DELETE",
                       choices=["DELETE", "FREE"])
        p.add_argument("path")
        p.add_argument("ttl_ms", type=int)

    def run(self, args, ctx):
        ctx.fs().set_attribute(args.path, ttl=args.ttl_ms,
                               ttl_action=args.action)
        ctx.print(f"TTL of path '{args.path}' was successfully set to "
                  f"{args.ttl_ms} milliseconds, with ttl action {args.action}")
        return 0


@FS_SHELL.register
class UnsetTtlCommand(Command):
    name, description = "unsetTtl", "Remove the TTL from a path."

    def configure(self, p):
        p.add_argument("path")

    def run(self, args, ctx):
        ctx.fs().set_attribute(args.path, ttl=-1)
        ctx.print(f"TTL of path '{args.path}' was successfully removed")
        return 0


@FS_SHELL.register
class SetReplicationCommand(Command):
    name, description = "setReplication", "Set replication min/max of a path."

    def configure(self, p):
        p.add_argument("--min", type=int, default=None, dest="rmin")
        p.add_argument("--max", type=int, default=None, dest="rmax")
        p.add_argument("-R", action="store_true", dest="recursive")
        p.add_argument("path")

    def run(self, args, ctx):
        if args.rmin is None and args.rmax is None:
            raise CommandError("at least one of --min/--max is required")
        ctx.fs().set_attribute(args.path, replication_min=args.rmin,
                               replication_max=args.rmax,
                               recursive=args.recursive)
        ctx.print(f"Changed the replication level of {args.path}")
        return 0


@FS_SHELL.register
class ChmodCommand(Command):
    name, description = "chmod", "Change the permission mode of a path."

    def configure(self, p):
        p.add_argument("-R", action="store_true", dest="recursive")
        p.add_argument("mode")
        p.add_argument("path")

    def run(self, args, ctx):
        try:
            mode = int(args.mode, 8)
        except ValueError:
            raise CommandError(f"invalid octal mode: {args.mode}")
        ctx.fs().set_attribute(args.path, mode=mode,
                               recursive=args.recursive)
        ctx.print(f"Changed permission of {args.path} to {args.mode}")
        return 0


@FS_SHELL.register
class ChownCommand(Command):
    name, description = "chown", "Change the owner (and group) of a path."

    def configure(self, p):
        p.add_argument("-R", action="store_true", dest="recursive")
        p.add_argument("owner", help="owner or owner:group")
        p.add_argument("path")

    def run(self, args, ctx):
        owner, _, group = args.owner.partition(":")
        ctx.fs().set_attribute(args.path, owner=owner, group=group or None,
                               recursive=args.recursive)
        ctx.print(f"Changed owner of {args.path} to {args.owner}")
        return 0


@FS_SHELL.register
class ChgrpCommand(Command):
    name, description = "chgrp", "Change the group of a path."

    def configure(self, p):
        p.add_argument("-R", action="store_true", dest="recursive")
        p.add_argument("group")
        p.add_argument("path")

    def run(self, args, ctx):
        ctx.fs().set_attribute(args.path, group=args.group,
                               recursive=args.recursive)
        ctx.print(f"Changed group of {args.path} to {args.group}")
        return 0


@FS_SHELL.register
class MountCommand(Command):
    name, description = "mount", "Mount a UFS uri into the namespace."

    def configure(self, p):
        p.add_argument("--readonly", action="store_true")
        p.add_argument("--shared", action="store_true")
        p.add_argument("-o", "--option", action="append", default=[],
                       help="key=value UFS property")
        p.add_argument("path", nargs="?")
        p.add_argument("ufs_uri", nargs="?")

    def run(self, args, ctx):
        fs = ctx.fs()
        if args.path is None:  # no args: print the mount table
            for m in fs.get_mount_points():
                ro = " [readonly]" if m.read_only else ""
                ctx.print(f"{m.ufs_uri:<40s} on {m.alluxio_path}{ro}")
            return 0
        if args.ufs_uri is None:
            raise CommandError("usage: mount [options] <path> <ufs-uri>")
        for o in args.option:
            if "=" not in o:
                raise CommandError(f"--option must be key=value, got {o!r}")
        props = dict(o.split("=", 1) for o in args.option)
        fs.mount(args.path, args.ufs_uri, read_only=args.readonly,
                 shared=args.shared, properties=props or None)
        ctx.print(f"Mounted {args.ufs_uri} at {args.path}")
        return 0


@FS_SHELL.register
class UnmountCommand(Command):
    name, description = "unmount", "Unmount a namespace path."

    def configure(self, p):
        p.add_argument("path")

    def run(self, args, ctx):
        ctx.fs().unmount(args.path)
        ctx.print(f"Unmounted {args.path}")
        return 0


@FS_SHELL.register
class LocationCommand(Command):
    name, description = "location", "Show which workers hold a file's blocks."

    def configure(self, p):
        p.add_argument("path")

    def run(self, args, ctx):
        fs = ctx.fs()
        infos = fs.fs_master.get_file_block_info_list(args.path)
        ctx.print(f"{args.path} with {len(infos)} blocks:")
        for fbi in infos:
            hosts = [f"{l.address.host}:{l.address.rpc_port}"
                     for l in fbi.block_info.locations] or ["<not cached>"]
            ctx.print(f"  block {fbi.block_info.block_id} "
                      f"(len {fbi.block_info.length}): {', '.join(hosts)}")
        return 0


@FS_SHELL.register
class GetCapacityBytesCommand(Command):
    name, description = "getCapacityBytes", "Total worker capacity in bytes."

    def run(self, args, ctx):
        cap = ctx.block_client().get_capacity()
        ctx.print(sum(cap["capacity"].values()))
        return 0


@FS_SHELL.register
class GetUsedBytesCommand(Command):
    name, description = "getUsedBytes", "Total used worker bytes."

    def run(self, args, ctx):
        cap = ctx.block_client().get_capacity()
        ctx.print(sum(cap["used"].values()))
        return 0


@FS_SHELL.register
class LeaderCommand(Command):
    name, description = "leader", "Print the primary master address."

    def run(self, args, ctx):
        ctx.meta_client().get_master_info()  # verifies it is serving
        ctx.print(ctx.master_address)
        return 0


@FS_SHELL.register
class MasterInfoCommand(Command):
    name, description = "masterInfo", "Print cluster/master information."

    def run(self, args, ctx):
        info = ctx.meta_client().get_master_info()
        for k in sorted(info):
            ctx.print(f"{k}: {info[k]}")
        return 0


@FS_SHELL.register
class SetfaclCommand(Command):
    name = "setfacl"
    description = "Set the ACL of a path (-m entries | -b to remove)."

    def configure(self, p):
        p.add_argument("-R", action="store_true", dest="recursive")
        p.add_argument("-d", action="store_true", dest="default",
                       help="operate on the default ACL (directories)")
        p.add_argument("-b", action="store_true", dest="remove_all",
                       help="remove the extended ACL")
        p.add_argument("-m", dest="entries", default=None,
                       help="comma-separated entries, e.g. user:alice:rwx")
        p.add_argument("path")

    def run(self, args, ctx):
        if args.remove_all:
            entries = []
        elif args.entries:
            entries = [e for e in args.entries.split(",") if e]
        else:
            raise CommandError("one of -m <entries> or -b is required")
        ctx.fs_client().set_acl(args.path, entries, default=args.default,
                                recursive=args.recursive)
        ctx.print(f"Modified ACL of {args.path}")
        return 0


@FS_SHELL.register
class GetfaclCommand(Command):
    name = "getfacl"
    description = "Show the ACL of a path."

    def configure(self, p):
        p.add_argument("path")

    def run(self, args, ctx):
        acl = ctx.fs_client().get_acl(args.path)
        ctx.print(f"# file: {args.path}")
        ctx.print(f"# owner: {acl['owner']}")
        ctx.print(f"# group: {acl['group']}")
        for e in acl["entries"]:
            ctx.print(e)
        for e in acl["default_entries"]:
            ctx.print(f"default:{e}" if not e.startswith("default:") else e)
        return 0


@FS_SHELL.register
class StartSyncCommand(Command):
    name = "startSync"
    description = "Register a path as an active sync point."

    def configure(self, p):
        p.add_argument("path")

    def run(self, args, ctx):
        ctx.fs_client().start_sync(args.path)
        ctx.print(f"Started automatic syncing of '{args.path}'")
        return 0


@FS_SHELL.register
class StopSyncCommand(Command):
    name = "stopSync"
    description = "Unregister an active sync point."

    def configure(self, p):
        p.add_argument("path")

    def run(self, args, ctx):
        ctx.fs_client().stop_sync(args.path)
        ctx.print(f"Stopped automatic syncing of '{args.path}'")
        return 0


@FS_SHELL.register
class GetSyncPathListCommand(Command):
    name = "getSyncPathList"
    description = "List the active sync points."

    def run(self, args, ctx):
        for p in ctx.fs_client().get_sync_path_list():
            ctx.print(p)
        return 0


def _run_distributed(ctx, config: dict, wait: bool) -> int:
    jc = ctx.job_client()
    job_id = jc.run(config)
    ctx.print(f"Submitted job {job_id}")
    if not wait:
        return 0
    info = jc.wait_for_job(job_id)
    ctx.print(f"Job {job_id} {info.status}"
              + (f": {info.error_message}" if info.error_message else ""))
    return 0 if info.status == "COMPLETED" else 1


@FS_SHELL.register
class DistributedLoadCommand(Command):
    name = "distributedLoad"
    description = "Cache a path onto workers via the job service."

    def configure(self, p):
        p.add_argument("--replication", type=int, default=1)
        p.add_argument("--no-wait", action="store_true", dest="no_wait")
        p.add_argument("path")

    def run(self, args, ctx):
        return _run_distributed(ctx, {
            "type": "load", "path": args.path,
            "replication": args.replication}, not args.no_wait)


@FS_SHELL.register
class DistributedCpCommand(Command):
    name = "distributedCp"
    description = "Copy a path via parallel job-service tasks."

    def configure(self, p):
        p.add_argument("--overwrite", action="store_true")
        p.add_argument("--no-wait", action="store_true", dest="no_wait")
        p.add_argument("src")
        p.add_argument("dst")

    def run(self, args, ctx):
        return _run_distributed(ctx, {
            "type": "migrate", "source": args.src, "destination": args.dst,
            "overwrite": args.overwrite}, not args.no_wait)


@FS_SHELL.register
class DistributedMvCommand(Command):
    name = "distributedMv"
    description = "Move a path via parallel job-service tasks."

    def configure(self, p):
        p.add_argument("--no-wait", action="store_true", dest="no_wait")
        p.add_argument("src")
        p.add_argument("dst")

    def run(self, args, ctx):
        return _run_distributed(ctx, {
            "type": "migrate", "source": args.src, "destination": args.dst,
            "overwrite": True, "delete_source": True}, not args.no_wait)


def main(argv=None) -> int:
    return FS_SHELL.run(sys.argv[1:] if argv is None else argv)
