"""Authorization: POSIX mode bits + access control lists (a copy of
``alluxio_tpu/security/authorization.py``).

Re-design of ``core/common/.../security/authorization/{Mode,AclEntry,
AccessControlList,DefaultAccessControlList}.java`` and the master-side
permission checker (``core/server/master/.../file/PermissionChecker.java``):
mode-bit checks walk the ancestor chain (EXECUTE on every directory),
ACLs extend them with named user/group entries and a mask, directories
can carry default ACLs inherited at create time.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, List, Optional, Sequence

from alluxio_tpu_torch.utils.exceptions import PermissionDeniedError

READ = 4
WRITE = 2
EXECUTE = 1

#: xattr keys carrying ACLs (single source of truth; the file master and
#: the checker both use these)
ACL_XATTR = "system.acl"
DEFAULT_ACL_XATTR = "system.default.acl"


def acl_entries_of(inode) -> "Optional[List[str]]":
    raw = inode.xattr.get(ACL_XATTR, "")
    return raw.split(",") if raw else None


def bits_to_string(bits: int) -> str:
    return (("r" if bits & READ else "-") + ("w" if bits & WRITE else "-")
            + ("x" if bits & EXECUTE else "-"))


@dataclass(frozen=True)
class AclEntry:
    """``user:alice:rwx`` / ``group:team:r-x`` / ``mask::rw-`` /
    ``other::r--`` (reference: AclEntry.toCliString)."""

    type: str          # user | group | mask | other | owner_user | owner_group
    subject: str       # empty for mask/other/owner entries
    bits: int
    is_default: bool = False

    def to_cli_string(self) -> str:
        prefix = "default:" if self.is_default else ""
        t = {"owner_user": "user", "owner_group": "group"}.get(
            self.type, self.type)
        return f"{prefix}{t}:{self.subject}:{bits_to_string(self.bits)}"

    @staticmethod
    def parse(text: str) -> "AclEntry":
        s = text.strip()
        is_default = s.startswith("default:")
        if is_default:
            s = s[len("default:"):]
        parts = s.split(":")
        if len(parts) != 3:
            raise ValueError(f"bad ACL entry: {text!r}")
        t, subject, perm = parts
        bits = 0
        for ch in perm:
            bits |= {"r": READ, "w": WRITE, "x": EXECUTE, "-": 0}[ch]
        if t == "user" and not subject:
            t = "owner_user"
        if t == "group" and not subject:
            t = "owner_group"
        return AclEntry(type=t, subject=subject, bits=bits,
                        is_default=is_default)


@dataclass
class AccessControlList:
    """Extended ACL over the owner/group/other base
    (reference: AccessControlList.java)."""

    named_users: dict = field(default_factory=dict)    # name -> bits
    named_groups: dict = field(default_factory=dict)   # name -> bits
    mask: Optional[int] = None

    def is_empty(self) -> bool:
        return not self.named_users and not self.named_groups \
            and self.mask is None

    def effective(self, bits: int) -> int:
        return bits & self.mask if self.mask is not None else bits

    def to_entries(self, is_default: bool = False) -> List[str]:
        out = []
        for name, bits in sorted(self.named_users.items()):
            out.append(AclEntry("user", name, bits,
                                is_default).to_cli_string())
        for name, bits in sorted(self.named_groups.items()):
            out.append(AclEntry("group", name, bits,
                                is_default).to_cli_string())
        if self.mask is not None:
            out.append(AclEntry("mask", "", self.mask,
                                is_default).to_cli_string())
        return out

    @staticmethod
    def from_entries(entries: Iterable[str]) -> "AccessControlList":
        acl = AccessControlList()
        for raw in entries:
            e = AclEntry.parse(raw)
            if e.type == "user":
                acl.named_users[e.subject] = e.bits
            elif e.type == "group":
                acl.named_groups[e.subject] = e.bits
            elif e.type == "mask":
                acl.mask = e.bits
        return acl


def check_bits(*, bits_wanted: int, user: str, groups: Sequence[str],
               owner: str, group: str, mode: int,
               acl_entries: Optional[List[str]] = None) -> bool:
    """POSIX + ACL evaluation order (reference:
    AccessControlList.checkPermission): owner, named users, owning/named
    groups, other. Per POSIX.1e, each matching group entry is evaluated
    INDIVIDUALLY (mask-limited): access is granted iff at least one entry
    alone carries every requested bit — entries are never OR-merged."""
    if user == owner:
        return (mode >> 6) & bits_wanted == bits_wanted
    acl = AccessControlList.from_entries(acl_entries or [])
    if user in acl.named_users:
        return acl.effective(acl.named_users[user]) & bits_wanted \
            == bits_wanted
    matched_group = False
    if group and group in groups:
        matched_group = True
        # the owning-group bits are mask-limited when an extended ACL exists
        if acl.effective((mode >> 3) & 7) & bits_wanted == bits_wanted:
            return True
    for g in groups:
        if g in acl.named_groups:
            matched_group = True
            if acl.effective(acl.named_groups[g]) & bits_wanted \
                    == bits_wanted:
                return True
    if matched_group:
        return False
    return mode & bits_wanted == bits_wanted


class PermissionChecker:
    """Master-side checks (reference: DefaultPermissionChecker):
    - traverse: EXECUTE on every ancestor directory
    - read/write on the target (or WRITE on the parent for create/delete)
    - owner-or-superuser for chmod/chgrp; superuser-only for chown."""

    def __init__(self, *, enabled: bool = True,
                 supergroup: str = "supergroup",
                 superuser: str = "") -> None:
        self.enabled = enabled
        self._supergroup = supergroup
        self._superuser = superuser or ""

    def is_superuser(self, user) -> bool:
        if user is None:
            return True  # in-process caller (no RPC context) is trusted
        return user.name == self._superuser or \
            self._supergroup in user.groups

    def check_traverse(self, user, chain) -> None:
        """chain: iterable of ancestor inodes (root..parent)."""
        if not self.enabled or user is None or self.is_superuser(user):
            return
        for inode in chain:
            if not inode.is_directory:
                continue
            if not check_bits(bits_wanted=EXECUTE, user=user.name,
                              groups=user.groups, owner=inode.owner,
                              group=inode.group, mode=inode.mode,
                              acl_entries=acl_entries_of(inode)):
                raise PermissionDeniedError(
                    f"user {user.name} lacks execute on "
                    f"ancestor {inode.name or '/'}")

    def check(self, user, inode, bits_wanted: int, *,
              path: str = "") -> None:
        if not self.enabled or user is None or self.is_superuser(user):
            return
        if not check_bits(bits_wanted=bits_wanted, user=user.name,
                          groups=user.groups, owner=inode.owner,
                          group=inode.group, mode=inode.mode,
                          acl_entries=acl_entries_of(inode)):
            raise PermissionDeniedError(
                f"user {user.name} lacks "
                f"{bits_to_string(bits_wanted).replace('-', '')} on "
                f"{path or inode.name}")

    def check_owner(self, user, inode, *, path: str = "") -> None:
        if not self.enabled or user is None or self.is_superuser(user):
            return
        if user.name != inode.owner:
            raise PermissionDeniedError(
                f"user {user.name} is not the owner of "
                f"{path or inode.name}")

    def check_superuser(self, user) -> None:
        if not self.enabled or user is None:
            return
        if not self.is_superuser(user):
            raise PermissionDeniedError(
                f"user {user.name} is not a superuser")
