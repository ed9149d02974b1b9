"""Authentication: metadata-borne identity + pluggable validation (a
copy of ``alluxio_tpu/security/authentication.py``; the port's worker
installs :func:`worker_authenticator` when worker QoS is on).

Re-design of ``security/authentication/{ChannelAuthenticator,
DefaultAuthenticationServer,AuthenticationProvider}.java`` +
``grpc/sasl_server.proto``: instead of a SASL side-stream, the client
attaches ``atpu-user`` (+ optional ``atpu-impersonate``, ``atpu-token``)
metadata to every RPC; the server validates per auth type and resolves
impersonation against the master's allow-list
(reference: ``ImpersonationAuthenticator``).
"""

from __future__ import annotations

import importlib
from typing import Callable, List, Optional, Tuple

from alluxio_tpu_torch.conf import Configuration, Keys, Templates
from alluxio_tpu_torch.security.user import (
    User, get_client_user, get_os_groups,
)
from alluxio_tpu_torch.utils.exceptions import (
    PermissionDeniedError, UnauthenticatedError,
)

USER_KEY = "atpu-user"
IMPERSONATE_KEY = "atpu-impersonate"
TOKEN_KEY = "atpu-token"

#: CUSTOM provider signature: (user, token) -> None, raise to reject
AuthenticationProvider = Callable[[str, str], None]


def load_custom_provider(spec: str) -> AuthenticationProvider:
    """``module.path:attr`` -> provider callable."""
    mod_name, _, attr = spec.partition(":")
    provider = getattr(importlib.import_module(mod_name), attr)
    return provider() if isinstance(provider, type) else provider


def client_metadata(conf: Optional[Configuration] = None
                    ) -> List[Tuple[str, str]]:
    """Metadata a client attaches to every call."""
    md = [(USER_KEY, get_client_user(conf))]
    if conf is not None:
        target = conf.get(Keys.SECURITY_LOGIN_IMPERSONATION_USERNAME)
        if target:
            md.append((IMPERSONATE_KEY, str(target)))
        token = conf.get(Keys.SECURITY_LOGIN_TOKEN)
        if token:
            md.append((TOKEN_KEY, str(token)))
    return md


def worker_authenticator(conf: Configuration):
    """The worker data plane's authenticator — installed only when
    worker QoS is on (per-tenant quotas need a principal on every RPC);
    None otherwise, keeping the QoS-off server byte-identical to a
    build without it.  One helper so every worker boot path
    (standalone launch, minicluster) stays in lockstep."""
    if not conf.get_bool(Keys.WORKER_QOS_ENABLED):
        return None
    return Authenticator(conf)


class Authenticator:
    """Server-side per-RPC authentication + impersonation resolution."""

    def __init__(self, conf: Optional[Configuration] = None) -> None:
        self._conf = conf or Configuration()
        self.auth_type = str(self._conf.get(Keys.SECURITY_AUTH_TYPE))
        self._provider: Optional[AuthenticationProvider] = None
        if self.auth_type == "CUSTOM":
            spec = self._conf.get(Keys.SECURITY_AUTH_CUSTOM_PROVIDER)
            if not spec:
                raise ValueError(
                    "CUSTOM auth needs atpu.security.authentication."
                    "custom.provider")
            self._provider = load_custom_provider(str(spec))

    def authenticate(self, metadata: dict) -> Optional[User]:
        """Metadata dict -> authenticated User (None when NOSASL)."""
        if self.auth_type == "NOSASL":
            return None
        name = metadata.get(USER_KEY, "")
        if not name:
            raise UnauthenticatedError(
                "no user in request metadata (SIMPLE/CUSTOM auth)")
        if self._provider is not None:
            try:
                self._provider(name, metadata.get(TOKEN_KEY, ""))
            except Exception as e:  # noqa: BLE001 - provider rejects
                raise UnauthenticatedError(
                    f"authentication failed for {name}: {e}") from None
        target = metadata.get(IMPERSONATE_KEY, "")
        if target and target != name:
            self._check_impersonation(name, target)
            return User(name=target,
                        groups=tuple(get_os_groups(target)),
                        connection_user=name)
        return User(name=name, groups=tuple(get_os_groups(name)))

    def _check_impersonation(self, connection_user: str,
                             target: str) -> None:
        """Reference: master-side impersonation allow-list
        (``alluxio.master.security.impersonation.<user>.users/groups``)."""
        allowed_users = self._conf.get_list(
            Templates.MASTER_IMPERSONATION_USERS.format(connection_user))
        allowed_groups = self._conf.get_list(
            Templates.MASTER_IMPERSONATION_GROUPS.format(connection_user))
        if "*" in allowed_users or target in allowed_users:
            return
        if allowed_groups:
            target_groups = set(get_os_groups(target))
            if "*" in allowed_groups or \
                    target_groups.intersection(allowed_groups):
                return
        raise PermissionDeniedError(
            f"user {connection_user!r} is not configured to impersonate "
            f"{target!r}")
