"""One seeded metadata scenario run through either package's
``FileSystemMaster`` + ``BlockMaster``: the parity tests of the port's
master (``tests/test_torch_master.py``) and of its journal
(``tests/test_torch_journal.py``) feed the same script to both and
compare what each observes.

``Masters(pkg, ...)`` builds the two masters of package ``pkg``
(``"alluxio_tpu"`` or ``"alluxio_tpu_torch"``) over a journal, with a
``ManualClock`` at a fixed start, the id generator seeded and a UFS root
of its own; ``make_script(seed, n)`` draws the operations; ``Masters.run``
applies one and returns what it observed (the result or the error type,
then the namespace, the block locations and the workers), with the
package's UFS root replaced by ``<UFS>`` so that the two packages'
observations compare equal.
"""

import importlib
import os

import numpy as np

PACKAGES = ("alluxio_tpu", "alluxio_tpu_torch")
START_MS = 1_700_000_000_000
BLOCK_SIZE = 4096
WORKER_TIMEOUT_MS = 60_000
#: one UFS tree for metadata loads, made identically under each root
UFS_FILES = {"ds/a.bin": 5000, "ds/b.bin": 300, "ds/sub/c.bin": 9000,
             "logs/x.txt": 17}
UFS_MTIME = 1_650_000_000


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def make_ufs_tree(root: str) -> None:
    """The seeded UFS content a mount loads, with fixed mtimes (the
    fingerprint keys on them)."""
    for rel, size in UFS_FILES.items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        data = np.random.default_rng(size).integers(
            0, 256, size, dtype=np.uint8).tobytes()
        with open(path, "wb") as f:
            f.write(data)
    for dirpath, dirnames, filenames in os.walk(root, topdown=False):
        for name in filenames + dirnames:
            os.utime(os.path.join(dirpath, name), (UFS_MTIME, UFS_MTIME))
    os.utime(root, (UFS_MTIME, UFS_MTIME))


class Masters:
    def __init__(self, pkg: str, base: str, *, journal: str = "local",
                 seed: int = 0, max_log_size: int = 64 << 20) -> None:
        self.pkg = pkg
        self.base = base
        ids = mod(pkg, "utils.ids")
        ids._rng.seed(seed)
        self.clock = mod(pkg, "utils.clock").ManualClock(START_MS)
        jmod = mod(pkg, "journal")
        self.journal_dir = os.path.join(base, "journal")
        if journal == "local":
            self.journal = jmod.LocalJournalSystem(
                self.journal_dir, max_log_size=max_log_size)
        else:
            self.journal = jmod.NoopJournalSystem()
        master = mod(pkg, "master")
        self.bm = master.BlockMaster(self.journal, clock=self.clock,
                                     worker_timeout_ms=WORKER_TIMEOUT_MS)
        self.fsm = master.FileSystemMaster(
            self.bm, self.journal, clock=self.clock,
            default_block_size=BLOCK_SIZE)
        self.ufs_root = os.path.join(base, "ufs")
        os.makedirs(os.path.join(self.ufs_root, "root"), exist_ok=True)
        make_ufs_tree(os.path.join(self.ufs_root, "mnt"))
        self.wire = mod(pkg, "utils.wire")
        self.user = mod(pkg, "security.user")
        self.workers = {}  # index -> worker id

    def start(self) -> "Masters":
        self.journal.start()
        self.journal.gain_primacy()
        self.fsm.start(os.path.join(self.ufs_root, "root"))
        return self

    def stop(self) -> None:
        self.fsm.stop()
        self.journal.stop()

    # -- normalisation ------------------------------------------------------
    def norm(self, obj):
        if isinstance(obj, str):
            return obj.replace(self.ufs_root, "<UFS>")
        if isinstance(obj, dict):
            return {k: self.norm(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return [self.norm(v) for v in obj]
        return obj

    # -- one operation ------------------------------------------------------
    def run(self, op: tuple) -> dict:
        kind, args = op[0], op[1:]
        user = args[-1] if kind in _AS_USER else None
        token = self.user.set_authenticated_user(
            self.user.User(name=user, groups=(user,))) if user else None
        try:
            result = self.norm(_result(getattr(self, "_" + kind)(*args)))
        except Exception as e:  # noqa: BLE001 - the error type is observed
            result = ("error", type(e).__name__)
        finally:
            if token is not None:
                self.user.reset_authenticated_user(token)
        return {"op": op, "result": result, **self.observe()}

    def observe(self) -> dict:
        fsm, bm = self.fsm, self.bm
        listing = [i.to_wire() for i in fsm.list_status("/", recursive=True)]
        blocks = {}
        for d in listing:
            for b in d["block_ids"]:
                try:
                    blocks[b] = bm.get_block_info(b).to_wire()
                except Exception as e:  # noqa: BLE001
                    blocks[b] = type(e).__name__
        return self.norm({
            "root": fsm.get_status("/").to_wire(),
            "listing": listing,
            "statuses": [fsm.get_status(d["path"]).to_wire()
                         for d in listing],
            "blocks": blocks,
            "workers": [w.to_wire() for w in
                        bm.get_worker_infos(include_lost=True)],
            # the UFS's capacity and use are the host disk's, live
            "mounts": [dict(m.to_wire(), ufs_capacity_bytes=0,
                            ufs_used_bytes=0)
                       for m in fsm.get_mount_points()],
        })

    # -- the operations -----------------------------------------------------
    def _mkdir(self, path, recursive):
        return self.fsm.create_directory(path, recursive=recursive)

    def _create(self, path, recursive, ttl, mode):
        return self.fsm.create_file(path, recursive=recursive, ttl=ttl,
                                    mode=mode)

    def _new_block(self, path):
        return self.fsm.get_new_block_id_for_file(path)

    def _complete(self, path, length):
        return self.fsm.complete_file(path, length=length)

    def _rename(self, src, dst):
        return self.fsm.rename(src, dst)

    def _delete(self, path, recursive):
        return self.fsm.delete(path, recursive=recursive)

    def _mount(self, path, sub):
        return self.fsm.mount(path, os.path.join(self.ufs_root, sub))

    def _unmount(self, path):
        return self.fsm.unmount(path)

    def _ttl(self, path, ttl):
        return self.fsm.set_attribute(path, ttl=ttl)

    def _pin(self, path, pinned):
        return self.fsm.set_attribute(path, pinned=pinned)

    def _chmod(self, path, mode, user):
        return self.fsm.set_attribute(path, mode=mode)

    def _set_acl(self, path, entries):
        self.fsm.set_acl(path, entries)
        return self.fsm.get_acl(path)

    def _free(self, path, recursive):
        return self.fsm.free(path, recursive=recursive)

    def _load(self, path):
        return self.fsm.get_status(path)

    def _list_as(self, path, user):
        return self.fsm.list_status(path)

    def _create_as(self, path, user):
        return self.fsm.create_file(path, recursive=True)

    def _register(self, index, blocks):
        address = self.wire.WorkerNetAddress(
            host=f"w{index}", rpc_port=29999 + index,
            tiered_identity=self.wire.TieredIdentity.from_spec(
                f"host=w{index},slice=s0"))
        wid = self.bm.get_worker_id(address)
        self.workers[index] = wid
        self.bm.worker_register(wid, {"MEM": 1 << 30}, {"MEM": 0},
                                {"MEM": list(blocks)}, address)
        return wid

    def _heartbeat(self, index, added, removed):
        wid = self.workers.get(index, 12345)
        return self.bm.worker_heartbeat(wid, {"MEM": 4096 * len(added)},
                                        {"MEM": list(added)}, list(removed))

    def _commit(self, index, block_id, length):
        wid = self.workers.get(index, 12345)
        return self.bm.commit_block(wid, length, "MEM", block_id, length)

    def _tick(self, ms):
        self.clock.add_time_ms(ms)
        return {"lost": sorted(self.bm.detect_lost_workers()),
                "ttl": sorted(self.fsm.check_ttl_expired())}


_AS_USER = ("chmod", "list_as", "create_as")


def _result(out):
    if hasattr(out, "to_wire"):
        return out.to_wire()
    if isinstance(out, (list, tuple)):
        return [_result(v) for v in out]
    if isinstance(out, set):
        return sorted(out)
    return out


# -- the script ---------------------------------------------------------------
_NAMES = ("a", "b", "c", "d")


def make_script(seed: int, n: int):
    """``n`` operations drawn from ``seed``. Paths come from a small pool
    so that most operations hit something that exists; the ones that
    miss are part of the comparison (the error type)."""
    rng = np.random.default_rng(seed)
    dirs = ["/"]
    files = []
    blocks = []

    def pick(seq):
        return seq[int(rng.integers(len(seq)))]

    def child(parent):
        return (parent.rstrip("/") + "/" + pick(_NAMES)
                + str(int(rng.integers(3))))

    ops = []
    ops.append(("register", 0, ()))
    ops.append(("register", 1, ()))
    for _ in range(n - 2):
        r = float(rng.random())
        if r < 0.12:
            d = child(pick(dirs))
            ops.append(("mkdir", d, bool(rng.random() < 0.7)))
            dirs.append(d)
        elif r < 0.30:
            f = child(pick(dirs))
            ttl = int(pick((-1, -1, -1, 30_000)))
            ops.append(("create", f, True, ttl, pick((None, 0o644, 0o600))))
            files.append(f)
        elif r < 0.40 and files:
            ops.append(("new_block", pick(files)))
            blocks.append(len(ops))
        elif r < 0.48 and files:
            ops.append(("complete", pick(files),
                        int(rng.integers(0, 3 * 4096))))
        elif r < 0.53:
            src = pick(files + dirs[1:]) if len(files + dirs) > 1 else "/x"
            dst = child(pick(dirs))
            ops.append(("rename", src, dst))
            (files if src in files else dirs).append(dst)
        elif r < 0.58:
            ops.append(("delete", pick(files + dirs),
                        bool(rng.random() < 0.5)))
        elif r < 0.61:
            ops.append(("mount", "/mnt" + str(int(rng.integers(2))),
                        pick(("mnt", "mnt/ds"))))
        elif r < 0.63:
            ops.append(("unmount", "/mnt" + str(int(rng.integers(2)))))
        elif r < 0.67:
            ops.append(("load", pick((
                "/mnt0/ds/a.bin", "/mnt0/ds/sub", "/mnt0/logs/x.txt",
                "/mnt1/a.bin", "/mnt1/sub/c.bin", "/mnt0/nope"))))
        elif r < 0.71:
            ops.append(("ttl", pick(files + dirs),
                        int(pick((10_000, 90_000, -1)))))
        elif r < 0.74:
            ops.append(("pin", pick(files + dirs), bool(rng.random() < 0.6)))
        elif r < 0.78:
            ops.append(("chmod", pick(files + dirs),
                        int(pick((0o700, 0o755, 0o644, 0o777))),
                        pick(("alice", "bob"))))
        elif r < 0.81:
            ops.append(("set_acl", pick(files + dirs),
                        [pick(("user:alice:rwx", "user:bob:r-x",
                               "group:eng:r--")), "mask::rwx"]))
        elif r < 0.83:
            ops.append(("free", pick(files + dirs), bool(rng.random() < 0.5)))
        elif r < 0.86:
            ops.append(("list_as", pick(dirs), pick(("alice", "bob"))))
        elif r < 0.88:
            ops.append(("create_as", child(pick(dirs)),
                        pick(("alice", "bob"))))
        elif r < 0.94:
            # a worker commits one of the blocks allocated so far: the
            # block id is the new_block op's result, resolved at run time
            ops.append(("commit_ref", int(rng.integers(2)),
                        int(pick(blocks)) if blocks else 0,
                        int(rng.integers(1, 4096))))
        elif r < 0.97:
            ops.append(("heartbeat_ref", int(rng.integers(2)),
                        int(pick(blocks)) if blocks else 0))
        else:
            ops.append(("tick", int(pick((5_000, 40_000, 70_000)))))
            if float(rng.random()) < 0.5:
                ops.append(("register", int(rng.integers(2)), ()))
    return ops


def resolve(op, results):
    """Turn the ``*_ref`` operations into concrete ones: the block id is
    the result of the ``new_block`` operation at the referenced index
    (1-based; 0 or a failed allocation gives a block no one has)."""
    kind = op[0]
    if kind not in ("commit_ref", "heartbeat_ref"):
        return op
    ref = op[2]
    got = results[ref - 1]["result"] if ref else None
    block_id = got if isinstance(got, int) else 999_999
    if kind == "commit_ref":
        return ("commit", op[1], block_id, op[3])
    return ("heartbeat", op[1], (block_id,), ())
