"""Security: per-RPC authentication (a copy of the part of
``alluxio_tpu/security`` that the worker uses). The identity rides in
per-RPC gRPC metadata, validated server-side; authorization and the
audit log come with the master."""

from alluxio_tpu_torch.security.user import (  # noqa: F401
    User, authenticated_user, get_client_user, set_authenticated_user,
)

__all__ = ["User", "authenticated_user", "get_client_user",
           "set_authenticated_user"]
