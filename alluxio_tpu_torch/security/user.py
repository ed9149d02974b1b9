"""User identity + per-request authentication context (a copy of
``alluxio_tpu/security/user.py``).

Re-design of ``security/user/User.java`` + ``AuthenticatedClientUser``
(thread-local in the reference -> contextvar here, which also survives
async handlers) and the group-mapping service
(``security/group/GroupMappingService``: OS groups by default).
"""

from __future__ import annotations

import contextvars
import getpass
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass(frozen=True)
class User:
    name: str
    groups: tuple = field(default_factory=tuple)
    #: the user that actually connected, when this one is impersonated
    connection_user: Optional[str] = None


def get_os_user() -> str:
    try:
        return getpass.getuser()
    except Exception:  # noqa: BLE001 - no passwd entry in some containers
        import os

        return os.environ.get("USER", f"uid-{os.getuid()}")


_GROUP_CACHE: dict = {}
_GROUP_CACHE_TTL_S = 60.0


def get_os_groups(user: str) -> List[str]:
    """OS group mapping, cached with a TTL — grp.getgrall() enumerates the
    whole group database (an NSS/LDAP round trip on some hosts) and this
    runs on the master's per-RPC authentication path (reference: the
    GroupMappingService cache)."""
    import time

    hit = _GROUP_CACHE.get(user)
    if hit is not None and time.monotonic() - hit[1] < _GROUP_CACHE_TTL_S:
        return list(hit[0])
    groups = _get_os_groups_uncached(user)
    _GROUP_CACHE[user] = (groups, time.monotonic())
    return list(groups)


def _get_os_groups_uncached(user: str) -> List[str]:
    try:
        import grp
        import pwd

        pw = pwd.getpwnam(user)
        groups = [g.gr_name for g in grp.getgrall() if user in g.gr_mem]
        primary = grp.getgrgid(pw.pw_gid).gr_name
        if primary not in groups:
            groups.insert(0, primary)
        return groups
    except (KeyError, ImportError):
        return []


_CURRENT_USER: contextvars.ContextVar[Optional[User]] = \
    contextvars.ContextVar("atpu_authenticated_user", default=None)


def authenticated_user() -> Optional[User]:
    """The user bound to the current RPC (server side)."""
    return _CURRENT_USER.get()


def set_authenticated_user(user: Optional[User]) -> contextvars.Token:
    return _CURRENT_USER.set(user)


def reset_authenticated_user(token: contextvars.Token) -> None:
    _CURRENT_USER.reset(token)


def get_client_user(conf=None) -> str:
    """The identity a client asserts (reference: LoginUser resolution:
    configured username, else the OS user)."""
    if conf is not None:
        from alluxio_tpu_torch.conf import Keys

        configured = conf.get(Keys.SECURITY_LOGIN_USERNAME)
        if configured:
            return str(configured)
    return get_os_user()
