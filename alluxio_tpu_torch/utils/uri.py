"""Path/URI type for the namespace: a copy of ``alluxio_tpu/utils/uri.py``.

Re-design of the reference's ``core/base/src/main/java/alluxio/AlluxioURI.java``:
an immutable URI with scheme/authority/path, path algebra (join, parent,
depth, descendant checks) and normalization. Scheme ``atpu://`` plays the role
of ``alluxio://``.
"""

from __future__ import annotations

import posixpath
import re
from typing import Optional, Tuple

SEPARATOR = "/"
_SCHEME_RE = re.compile(r"^([a-zA-Z][a-zA-Z0-9+.\-]*)://(.*)$")


class AlluxioURI:
    """Immutable URI: ``[scheme://[authority]]/normalized/path``."""

    __slots__ = ("_scheme", "_authority", "_path")

    def __init__(self, uri: "str | AlluxioURI", *, scheme: Optional[str] = None,
                 authority: Optional[str] = None, path: Optional[str] = None):
        if isinstance(uri, AlluxioURI):
            self._scheme, self._authority, self._path = (
                uri._scheme, uri._authority, uri._path)
            return
        if path is not None:
            self._scheme = scheme
            self._authority = authority
            self._path = self._normalize(path)
            return
        s = str(uri)
        m = _SCHEME_RE.match(s)
        if m:
            self._scheme = m.group(1)
            rest = m.group(2)
            if SEPARATOR in rest:
                auth, _, p = rest.partition(SEPARATOR)
            else:
                auth, p = rest, ""
            self._authority = auth or None
            self._path = self._normalize(SEPARATOR + p)
        else:
            self._scheme = None
            self._authority = None
            self._path = self._normalize(s)

    @staticmethod
    def _normalize(path: str) -> str:
        if not path:
            return SEPARATOR
        norm = posixpath.normpath(path)
        if norm == ".":
            return SEPARATOR
        if not norm.startswith(SEPARATOR):
            norm = SEPARATOR + norm
        return norm

    # -- accessors ----------------------------------------------------------
    @property
    def scheme(self) -> Optional[str]:
        return self._scheme

    @property
    def authority(self) -> Optional[str]:
        return self._authority

    @property
    def path(self) -> str:
        return self._path

    @property
    def name(self) -> str:
        return posixpath.basename(self._path)

    def is_root(self) -> bool:
        return self._path == SEPARATOR

    def is_absolute(self) -> bool:
        return self._path.startswith(SEPARATOR)

    def has_scheme(self) -> bool:
        return self._scheme is not None

    def depth(self) -> int:
        if self.is_root():
            return 0
        return self._path.count(SEPARATOR)

    # -- algebra ------------------------------------------------------------
    def parent(self) -> Optional["AlluxioURI"]:
        if self.is_root():
            return None
        parent_path = posixpath.dirname(self._path)
        return AlluxioURI("", scheme=self._scheme, authority=self._authority,
                          path=parent_path)

    def join(self, suffix: str) -> "AlluxioURI":
        suffix = suffix.lstrip(SEPARATOR)
        base = self._path if self._path != SEPARATOR else ""
        return AlluxioURI("", scheme=self._scheme, authority=self._authority,
                          path=f"{base}{SEPARATOR}{suffix}")

    def path_components(self) -> Tuple[str, ...]:
        if self.is_root():
            return ()
        return tuple(self._path.strip(SEPARATOR).split(SEPARATOR))

    def is_ancestor_of(self, other: "AlluxioURI") -> bool:
        """True if ``other`` lives strictly under (or at) this path."""
        if self.is_root():
            return True
        mine = self._path.rstrip(SEPARATOR)
        theirs = other._path
        return theirs == mine or theirs.startswith(mine + SEPARATOR)

    # -- std protocol -------------------------------------------------------
    def __str__(self) -> str:
        if self._scheme:
            return f"{self._scheme}://{self._authority or ''}{self._path}"
        return self._path

    def __repr__(self) -> str:
        return f"AlluxioURI({str(self)!r})"

    def __eq__(self, other) -> bool:
        if isinstance(other, str):
            other = AlluxioURI(other)
        if not isinstance(other, AlluxioURI):
            return NotImplemented
        return (self._scheme, self._authority, self._path) == (
            other._scheme, other._authority, other._path)

    def __hash__(self) -> int:
        return hash((self._scheme, self._authority, self._path))

    def __lt__(self, other: "AlluxioURI") -> bool:
        return str(self) < str(other)
