"""The port's master against the JAX package's, on the CPU.

- A seeded script of about 200 operations (mkdir, create, new block,
  complete, rename, delete, mount, unmount, set_attribute with TTL, pinned
  and mode, set_acl, free, metadata loads from a local UFS, worker
  registration, heartbeats and commits, and lost-worker and TTL detection
  on a ``ManualClock``) goes through both packages' ``FileSystemMaster`` +
  ``BlockMaster``, each over a ``LocalJournalSystem``. After every
  operation the result or the error type, ``get_status`` and
  ``list_status`` as wire dicts, the block locations, the workers and the
  mount points are equal; so is the sequence of journal entries (type and
  payload) the two journals hold at the end.
- The helpers the file master calls inline: ``AlluxioURI``, the
  authorization bits and ACLs, the path properties and the config checker,
  the metastore factory — each against its JAX counterpart.
- The port's master process refuses the opt-in components it does not
  have (a typed error), and an LSM-native checkpoint raises one.
"""

import os

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from tests.testutils.torch_master import (  # noqa: E402
    PACKAGES, Masters, make_script, mod, resolve,
)

SEEDS = (0, 1, 2, 3)


def _journal_entries(m: Masters):
    fmt = mod(m.pkg, "journal.format")
    system = mod(m.pkg, "journal.system")
    logs = os.path.join(m.journal_dir, "logs")
    out = []
    for seg in system.sorted_segments(logs):
        with open(os.path.join(logs, seg), "rb") as f:
            out += [(e.sequence, e.type, m.norm(e.payload))
                    for e in fmt.JournalEntry.decode_stream(f)]
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_operation_script_matches_jax(tmp_path, seed):
    script = make_script(seed, 200)
    masters = [Masters(pkg, str(tmp_path / pkg), seed=seed).start()
               for pkg in PACKAGES]
    seen = ([], [])
    try:
        for i, op in enumerate(script):
            obs = [m.run(resolve(op, seen[k]))
                   for k, m in enumerate(masters)]
            for k in (0, 1):
                seen[k].append(obs[k])
            assert obs[1] == obs[0], f"operation {i}: {op}"
    finally:
        for m in masters:
            m.stop()
    errors = {o["result"][1] for o in seen[0]
              if isinstance(o["result"], tuple)}
    # the script reaches the typed errors as well as the happy paths
    assert {"FileDoesNotExistError", "PermissionDeniedError"} <= errors
    want, got = (_journal_entries(m) for m in masters)
    assert got == want and len(want) > 100


# -- the file master's helpers ------------------------------------------------
_URIS = ("/", "/a", "/a/b/", "//a//b/./c", "/a/b/../c", "atpu://host:1/x/y",
         "a/b", "/a/b/c.bin")


@pytest.mark.parametrize("text", _URIS)
def test_uri_matches_jax(text):
    out = []
    for pkg in PACKAGES:
        uri = mod(pkg, "utils.uri").AlluxioURI(text)
        parent = uri.parent()
        out.append((str(uri), uri.path, uri.name, uri.depth(), uri.is_root(),
                    uri.scheme, uri.authority, uri.path_components(),
                    str(parent) if parent is not None else None,
                    str(uri.join("z")),
                    uri.is_ancestor_of(type(uri)("/a/b/c/d"))))
    assert out[1] == out[0]


def test_check_bits_matches_jax():
    rng = np.random.default_rng(5)
    users = ("alice", "bob", "carol")
    got = {pkg: [] for pkg in PACKAGES}
    cases = []
    for _ in range(300):
        mode = int(rng.integers(0, 0o1000))
        user = users[int(rng.integers(3))]
        owner = users[int(rng.integers(3))]
        entries = [e for e in ("user:bob:r-x", "group:eng:rw-",
                               "user:carol:---", "mask::r-x")
                   if rng.random() < 0.4]
        cases.append((int(rng.integers(1, 8)), user, owner, mode, entries))
    for pkg in PACKAGES:
        auth = mod(pkg, "security.authorization")
        for bits, user, owner, mode, entries in cases:
            acl = auth.AccessControlList.from_entries(entries)
            got[pkg].append((
                auth.check_bits(bits_wanted=bits, user=user,
                                groups=("eng",) if user == "bob" else (),
                                owner=owner, group="eng", mode=mode,
                                acl_entries=entries),
                acl.to_entries(), acl.to_entries(is_default=True),
                acl.is_empty(), auth.bits_to_string(bits)))
    assert got[PACKAGES[1]] == got[PACKAGES[0]]


def test_path_properties_and_config_report_match_jax():
    out = []
    for pkg in PACKAGES:
        pp = mod(pkg, "master.path_properties")
        journal = mod(pkg, "journal").NoopJournalSystem()
        props = pp.PathProperties(journal)
        props.add("/a", {"atpu.user.file.writetype.default": "THROUGH"})
        props.add("/a/b", {"atpu.user.file.writetype.default": "MUST_CACHE",
                           "atpu.user.file.replication.min": "2"})
        props.remove("/a/b", ["atpu.user.file.replication.min"])
        resolved = [pp.resolve_path_property(
            props.get_all(), p, "atpu.user.file.writetype.default")
            for p in ("/", "/a", "/a/x", "/a/b/c", "/ab")]
        checker = pp.ConfigurationChecker()
        checker.register("master", {"atpu.security.authentication.type":
                                    "SIMPLE", "atpu.user.file.replication.max":
                                    "3"})
        checker.register("worker-1", {"atpu.security.authentication.type":
                                      "NOSASL", "atpu.user.file.replication.max":
                                      "5"})
        out.append((props.get_all(), props.hash(), resolved,
                    checker.report(), props.snapshot()))
    assert out[1] == out[0]
    assert out[0][3]["status"] == "FAILED"


@pytest.mark.parametrize("kind", ("HEAP", "heap", "SQLITE", "LSM", "CACHING",
                                  "CACHING:LSM", "ROCKS"))
def test_metastore_factory(tmp_path, kind):
    from alluxio_tpu.master.metastore import create_inode_store as jax_create
    from alluxio_tpu_torch.master.metastore import (HeapInodeStore,
                                                    create_inode_store)
    from alluxio_tpu_torch.utils.exceptions import InvalidArgumentError

    if kind.upper() == "HEAP":
        assert isinstance(create_inode_store(kind, str(tmp_path)),
                          HeapInodeStore)
        return
    from alluxio_tpu.utils.exceptions import (
        InvalidArgumentError as JaxInvalidArgumentError,
    )

    with pytest.raises(InvalidArgumentError) as info:
        create_inode_store(kind, str(tmp_path))
    if kind == "ROCKS":  # a kind neither package knows: the same error
        with pytest.raises(JaxInvalidArgumentError):
            jax_create(kind, str(tmp_path))
    else:  # a JAX kind the port has not yet: the message names the slice
        assert "slice" in str(info.value)


def test_lsm_checkpoint_raises_typed_error():
    from alluxio_tpu_torch.master.inode_tree import InodeTree
    from alluxio_tpu_torch.utils.exceptions import NotSupportedError

    with pytest.raises(NotSupportedError):
        InodeTree().restore({"root_id": 1, "store_state": {"runs": []}})


@pytest.mark.parametrize("key", (
    "atpu.master.rpc.admission.enabled", "atpu.master.web.enabled",
    "atpu.master.update.check.enabled", "atpu.master.daily.backup.enabled",
    "atpu.master.remediation.enabled", "atpu.master.journal.init.from.backup",
))
def test_master_process_refuses_unported_components(tmp_path, key):
    from alluxio_tpu_torch.conf import Configuration, Keys
    from alluxio_tpu_torch.master.process import MasterProcess
    from alluxio_tpu_torch.utils.exceptions import NotSupportedError

    conf = Configuration(load_env=False)
    conf.set(Keys.MASTER_JOURNAL_FOLDER, str(tmp_path / "journal"))
    conf.set(key, str(tmp_path / "backup.bak")
             if key.endswith("backup") else True)
    with pytest.raises(NotSupportedError, match=key.replace(".", r"\.")):
        MasterProcess(conf, root_ufs_uri=str(tmp_path))


def test_embedded_journal_is_refused(tmp_path):
    from alluxio_tpu_torch.journal import create_journal_system

    with pytest.raises(ValueError, match="EMBEDDED"):
        create_journal_system("EMBEDDED", str(tmp_path))
