"""Analyzer 6: native ABI discipline.

The ctypes boundary has no type checker: a prototype in
``native/__init__.py`` that names a symbol the compiled ``.so`` does
not export fails at ``lib()`` attach time (silently disabling the whole
native layer), and an ``extern "C"`` entry point with no declared
prototype is dead export surface nothing on the Python side can call
safely. Both are signature drift that should fail lint, not segfault
(or silently slow down) a run.

The rule diffs ``native._PROTOTYPES`` — the single source of truth the
loader attaches from — against the defined ``atpu_*`` function symbols
in the compiled library's ELF ``.dynsym`` table (built on demand, same
as the runtime):

- ``native-abi-missing-symbol``     declared prototype with no exported
                                    symbol in the compiled ``.so``
- ``native-abi-undeclared-symbol``  exported ``atpu_*`` symbol with no
                                    ctypes prototype

No toolchain (the build fails exactly like it would at runtime) or an
unparsable ``.so``: stay silent — the runtime falls back to pure
Python there too, so there is no ABI to drift.
"""

from __future__ import annotations

from typing import List

from alluxio_tpu_torch.lint.collect import RepoFacts
from alluxio_tpu_torch.lint.findings import Finding
from alluxio_tpu_torch.lint.model import RepoModel

RULES = ("native-abi-missing-symbol", "native-abi-undeclared-symbol")

_LOADER = "alluxio_tpu_torch/native/__init__.py"


def _line_of(model: RepoModel, needle: str) -> int:
    for pf in model.py_files:
        if pf.path != _LOADER:
            continue
        for i, line in enumerate(pf.text.splitlines(), start=1):
            if f'"{needle}"' in line:
                return i
        break
    return 1


def analyze(model: RepoModel, facts: RepoFacts) -> List[Finding]:
    findings: List[Finding] = []
    if not any(pf.path == _LOADER for pf in model.py_files):
        # partial scan without the loader: nothing to diff against
        return findings
    try:
        from alluxio_tpu_torch import native
    except Exception:  # noqa: BLE001 - broken import is a test failure
        return findings
    symbols = native.exported_symbols()
    if symbols is None:
        # no toolchain / unparsable .so: the runtime falls back to
        # pure Python here too — no ABI exists to drift
        return findings
    declared = set(native._PROTOTYPES)
    exported = set(symbols)
    for name in sorted(declared - exported):
        findings.append(Finding(
            rule="native-abi-missing-symbol", path=_LOADER,
            line=_line_of(model, name), anchor=name,
            message=f"ctypes prototype '{name}' has no exported symbol "
                    f"in the compiled .so — lib() would fail to attach "
                    f"and silently disable the whole native layer; add "
                    f"the extern \"C\" entry point or drop the "
                    f"prototype"))
    for name in sorted(exported - declared):
        findings.append(Finding(
            rule="native-abi-undeclared-symbol", path=_LOADER,
            line=_line_of(model, name), anchor=name,
            message=f"compiled .so exports '{name}' with no ctypes "
                    f"prototype in native._PROTOTYPES — undeclared "
                    f"entry points have no argtypes/restype and "
                    f"segfault on drift; declare it or remove the "
                    f"export"))
    return findings
