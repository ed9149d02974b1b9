"""The port's public surface against the JAX package's, read with ``ast``.

For each module of ``alluxio_tpu/`` the port's file at the same path
(``client/jax_io.py`` -> ``client/torch_io.py``) must have:

- every public (no leading ``_``) module-level function, class and
  constant;
- every public method and class attribute of each public class (a
  method the port's class inherits from another class of the port
  counts, and so does an attribute a method sets on ``self``), and the
  parameters of ``__init__`` and ``__call__``;
- every parameter name of each public function and method (a
  ``**kwargs`` in the port's signature is not a parameter that is
  there);
- every name a package's ``__init__.py`` re-exports, by import, by
  ``__all__`` or by its lazy ``_LAZY`` table.

What the port leaves out on purpose is in ``ALLOWLIST``, one entry per
name or parameter, each with its reason and, where one exists, the port
test that pins the difference. Only JAX idiom with a PyTorch
counterpart, and what the reference itself refuses or never runs, is
admitted. An entry that the port now has, or that the JAX package no
longer has, fails its module's case as stale.

Neither package is imported by the comparison; the only import of the
port is its lock-audit fixtures, as in every port test file.
"""

import ast
import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import pytest

from alluxio_tpu_torch.lint.pytest_lockaudit import (  # noqa: F401
    port_lock_order_audit, port_lockaudit_install,
)

ROOT = Path(__file__).resolve().parents[1]
JAX = ROOT / "alluxio_tpu"
PORT = ROOT / "alluxio_tpu_torch"
#: JAX file -> the port's file, where the paths differ
RENAMED = {"client/jax_io.py": "client/torch_io.py"}

_JAXIO = "JAX idiom"

#: "<JAX file>::<gap>" -> (reason, the port test that pins it or None).
#: A gap is ``name``, ``Class.member``, ``func(param)`` or
#: ``Class.method(param)``.
ALLOWLIST: Dict[str, Tuple[str, Optional[str]]] = {
    # -- the model: a functional pytree in JAX, an nn.Module in the port
    "models/__init__.py::init_params": (
        f"{_JAXIO}: the port's model is the Transformer module, built from "
        "a seeded torch.Generator with the JAX tree's parameter names",
        "tests/test_torch_transformer.py::"
        "test_param_names_and_shapes_match_the_jax_tree"),
    "models/transformer.py::init_params": (
        f"{_JAXIO}: Transformer(cfg, seed=...) builds the parameters",
        "tests/test_torch_transformer.py::"
        "test_param_names_and_shapes_match_the_jax_tree"),
    "models/transformer.py::forward(params)": (
        f"{_JAXIO}: the port's forward takes the module, which holds the "
        "parameters",
        "tests/test_torch_transformer.py::test_forward_with_aux_dense"),
    "models/transformer.py::forward(cfg)": (
        f"{_JAXIO}: the module carries its TransformerConfig",
        "tests/test_torch_transformer.py::test_forward_with_aux_dense"),
    "models/transformer.py::forward_with_aux(params)": (
        f"{_JAXIO}: the port's forward_with_aux takes the module",
        "tests/test_torch_transformer.py::test_forward_with_aux_dense"),
    "models/transformer.py::forward_with_aux(cfg)": (
        f"{_JAXIO}: the module carries its TransformerConfig",
        "tests/test_torch_transformer.py::test_forward_with_aux_moe"),
    "models/transformer.py::loss_fn(params)": (
        f"{_JAXIO}: the port's loss_fn takes the module",
        "tests/test_torch_transformer.py::test_loss_and_gradients"),
    "models/transformer.py::loss_fn(cfg)": (
        f"{_JAXIO}: the module carries its TransformerConfig",
        "tests/test_torch_transformer.py::test_loss_and_gradients"),
    # -- the train step: jit with NamedShardings in JAX
    "models/train.py::make_train_step(shardings)": (
        f"{_JAXIO}: jit's in/out NamedShardings; the port's step takes "
        "mesh= and the model holds its shards",
        "tests/test_torch_sharded_train.py::"
        "test_three_dp_tp_steps_match_the_jax_step"),
    "models/train.py::make_eval_step(shardings)": (
        f"{_JAXIO}: jit's in NamedShardings; the port's step takes mesh=",
        "tests/test_torch_sharded_train.py::"
        "test_three_dp_tp_steps_match_the_jax_step"),
    "models/train.py::make_train_step(seq_parallel)": (
        "the reference's step raises with it (NameError: unbound axis "
        "name, ROADMAP.md section 3); the port's forward and loss_fn take "
        "seq_axis=",
        "tests/test_torch_parallel_grad.py::"
        "test_seq_parallel_transformer_grads_match_jax"),
    # -- the mesh: jax.sharding in JAX, torch.distributed in the port
    "parallel/__init__.py::named_sharding": (
        f"{_JAXIO}: a NamedSharding; the port's layouts are mesh.layout",
        "tests/test_torch_mesh.py::test_layout_of_a_partition_spec"),
    "parallel/__init__.py::replicated": (
        f"{_JAXIO}: a NamedSharding; the port's is mesh.REPLICATED",
        "tests/test_torch_mesh.py::test_shard_and_gather"),
    "parallel/mesh.py::named_sharding": (
        f"{_JAXIO}: a NamedSharding; the port's layouts are mesh.layout",
        "tests/test_torch_mesh.py::test_layout_of_a_partition_spec"),
    "parallel/mesh.py::replicated": (
        f"{_JAXIO}: a NamedSharding; the port's is mesh.REPLICATED",
        "tests/test_torch_mesh.py::test_shard_and_gather"),
    "parallel/mesh.py::make_mesh(devices)": (
        f"{_JAXIO}: jax.devices(); a port mesh is one process per card, "
        "its rank and card from torch.distributed",
        "tests/test_torch_mesh.py::test_ranks_take_the_jax_mesh_positions"),
    "parallel/moe.py::init_moe_params(key)": (
        f"{_JAXIO}: a PRNG key; the port takes a torch.Generator",
        "tests/test_torch_parallel.py::test_moe_expert_parallel_matches_jax"),
    "parallel/moe.py::moe_param_shardings": (
        f"{_JAXIO}: NamedShardings; the port's shard_moe_params lays "
        "the tensors out by moe_param_specs",
        "tests/test_torch_parallel.py::test_moe_expert_parallel_matches_jax"),
    "parallel/ring_attention.py::ring_attention_local(axis_name)": (
        f"{_JAXIO}: a shard_map axis name; the port's takes the "
        "torch.distributed group",
        "tests/test_torch_parallel.py::test_ring_attention_matches_jax"),
    # -- the kernel: Pallas in JAX, CUDA in the port
    "ops/reduce_kernel.py::available": (
        f"{_JAXIO}: whether Pallas imports; the port's kernel is built "
        "by nvcc at first launch and a failed build raises",
        "tests/test_torch_reduce_kernel.py::"
        "TestPortContract::test_build_without_nvcc_raises"),
    "ops/reduce_kernel.py::scaled_sum(interpret)": (
        f"{_JAXIO}: Pallas interpret mode; a CUDA kernel has none, and a "
        "CPU tensor takes the plain version",
        "tests/test_torch_reduce_kernel.py::"
        "TestPortContract::test_cpu_path_launches_no_kernel"),
    "client/cache/hbm_store.py::HbmPageStore.adopt(device_array)": (
        f"{_JAXIO}: a jax.Array; the port adopts a tensor (and the event "
        "of the copy that filled it)",
        "tests/test_torch_hbm_store.py::"
        "TestPortStore::test_adopt_keeps_the_tensor_and_checks_device"),
    # -- the suite's device leg: the jax module in JAX, a device in the port
    "stress/tpu_suite.py::config2_random_4k(jax)": (
        f"{_JAXIO}: the jax module handle; the port takes a torch device",
        "tests/test_torch_stress.py::test_config2_rows_carry_the_jax_keys"),
    "stress/tpu_suite.py::config3_prefetch(jax)": (
        f"{_JAXIO}: the jax module handle; the port takes a torch device",
        "tests/test_torch_stress.py::test_config3_rows_carry_the_jax_keys"),
    "stress/tpu_suite.py::config4_projection(jax)": (
        f"{_JAXIO}: the jax module handle; the port takes a torch device",
        "tests/test_torch_stress.py::test_config4_rows_carry_the_jax_keys"),
    "stress/tpu_suite.py::run_all(jax)": (
        f"{_JAXIO}: the jax module handle; the port takes a torch device",
        "tests/test_torch_stress.py::test_run_all_runs_the_three_configs"),
    # -- what the reference refuses
    "stress/write_bench.py::run(master)": (
        "the reference raises NotImplementedError for any master "
        "(alluxio_tpu/stress/write_bench.py:32-34)",
        "tests/test_torch_stress.py::test_write_bench_small_passes_in_both"),
    "stress/prefetch_bench.py::run(master)": (
        "the reference raises NotImplementedError for any master "
        "(alluxio_tpu/stress/prefetch_bench.py:36-38)",
        "tests/test_torch_stress.py::"
        "test_prefetch_bench_moves_cold_corpus_in_both"),
    # -- the lint's doc writers: the port's lint reads and writes no docs
    "lint/collect.py::DocToken": (
        "the port's lint reads no docs (ROADMAP.md, Constraints)",
        "tests/test_torch_lint.py::test_port_lint_reads_no_docs"),
    "lint/collect.py::doc_tokens": (
        "the port's lint reads no docs (ROADMAP.md, Constraints)",
        "tests/test_torch_lint.py::test_port_lint_reads_no_docs"),
    "lint/conf_analyzer.py::write_conf_doc": (
        "the port's lint writes no docs (ROADMAP.md, Constraints)",
        "tests/test_torch_lint.py::test_port_lint_reads_no_docs"),
    "lint/metrics_analyzer.py::write_metrics_doc": (
        "the port's lint writes no docs (ROADMAP.md, Constraints)",
        "tests/test_torch_lint.py::test_port_lint_reads_no_docs"),
    "lint/model.py::DOC_EXTRA": (
        "the port's lint reads no docs (ROADMAP.md, Constraints)",
        "tests/test_torch_lint.py::test_port_lint_reads_no_docs"),
    "lint/model.py::DOC_ROOTS": (
        "the port's lint reads no docs (ROADMAP.md, Constraints)",
        "tests/test_torch_lint.py::test_port_lint_reads_no_docs"),
    "lint/model.py::DocFile": (
        "the port's lint reads no docs (ROADMAP.md, Constraints)",
        "tests/test_torch_lint.py::test_port_lint_reads_no_docs"),
    "lint/model.py::RepoModel.doc_files": (
        "the port's lint reads no docs (ROADMAP.md, Constraints)",
        "tests/test_torch_lint.py::test_port_lint_reads_no_docs"),
}


# -- the comparison -----------------------------------------------------------
_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)
_ASSIGNS = (ast.Assign, ast.AnnAssign)


def _flat(body):
    """Statements of a body, with those under ``if``/``try`` inlined."""
    for node in body:
        if isinstance(node, ast.If):
            yield from _flat(node.body)
            yield from _flat(node.orelse)
        elif isinstance(node, ast.Try):
            yield from _flat(node.body)
            for h in node.handlers:
                yield from _flat(h.body)
            yield from _flat(node.orelse)
            yield from _flat(node.finalbody)
        else:
            yield node


def _targets(node) -> List[str]:
    targets = node.targets if isinstance(node, ast.Assign) else [node.target]
    return [n.id for t in targets for n in ast.walk(t)
            if isinstance(n, ast.Name)]


def _params(fn) -> List[str]:
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs
            if x.arg not in ("self", "cls")]


def _public(name: str) -> bool:
    return not name.startswith("_")


class _Module:
    def __init__(self, path: Path, root: Path) -> None:
        rel = path.relative_to(root.parent).with_suffix("")
        self.is_pkg = path.name == "__init__.py"
        parts = rel.parts[:-1] if self.is_pkg else rel.parts
        self.name = ".".join(parts)
        self.defs: Dict[str, ast.AST] = {}
        self.imports: Dict[str, Tuple[str, str]] = {}
        self.bound = set()
        self.exported = set()  # __all__ and _LAZY
        self.lazy: Dict[str, str] = {}
        for node in _flat(ast.parse(path.read_text()).body):
            if isinstance(node, _FUNCS + (ast.ClassDef,)):
                self.defs[node.name] = node
                self.bound.add(node.name)
            elif isinstance(node, _ASSIGNS):
                for t in _targets(node):
                    self.bound.add(t)
                    self.defs.setdefault(t, node)
                    value = node.value
                    if t == "__all__" and isinstance(value, (ast.List,
                                                             ast.Tuple)):
                        self.exported |= {e.value for e in value.elts}
                    elif t == "_LAZY" and isinstance(value, ast.Dict):
                        self.lazy = {k.value: v.value for k, v in
                                     zip(value.keys, value.values)}
                        self.exported |= set(self.lazy)
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                if node.level:
                    pkg = self.name.split(".")
                    pkg = pkg if self.is_pkg else pkg[:-1]
                    pkg = pkg[:len(pkg) - (node.level - 1)]
                    base = ".".join(pkg + ([base] if base else []))
                for a in node.names:
                    self.imports[a.asname or a.name] = (base, a.name)
                    self.bound.add(a.asname or a.name)
            elif isinstance(node, ast.Import):
                for a in node.names:
                    self.bound.add(a.asname or a.name.split(".")[0])

    def public_names(self):
        names = {n for n in self.defs if _public(n)}
        if self.is_pkg:
            names |= {n for n in self.imports if _public(n)}
            names |= self.exported
        return names


def load(root: Path) -> Dict[str, _Module]:
    mods = {}
    for p in sorted(root.rglob("*.py")):
        m = _Module(p, root)
        mods[m.name] = m
    return mods


def _resolve(mods, modname: str, name: str, depth: int = 0):
    """(module, definition node) of ``name`` as seen from ``modname``,
    through imports, lazy tables and ``A = B`` aliases; None when the
    name is not defined in the package."""
    m = mods.get(modname)
    if m is None or depth > 8:
        return None
    node = m.defs.get(name)
    if node is not None and not isinstance(node, _ASSIGNS):
        return m, node
    if name in m.imports:
        src, attr = m.imports[name]
        return _resolve(mods, src, attr, depth + 1)
    if name in m.lazy:
        return _resolve(mods, m.lazy[name], name, depth + 1)
    if isinstance(node, ast.Assign) and isinstance(node.value, ast.Name):
        return _resolve(mods, modname, node.value.id, depth + 1)
    return (m, node) if node is not None else None


def _members(cls: ast.ClassDef):
    meths, attrs = {}, set()
    for node in _flat(cls.body):
        if isinstance(node, _FUNCS):
            meths[node.name] = node
            for sub in ast.walk(node):
                if isinstance(sub, ast.Attribute) and \
                        isinstance(sub.ctx, ast.Store) and \
                        isinstance(sub.value, ast.Name) and \
                        sub.value.id == "self":
                    attrs.add(sub.attr)
        elif isinstance(node, _ASSIGNS):
            attrs |= set(_targets(node))
    return meths, attrs


def _class_attr_names(cls: ast.ClassDef):
    return {t for node in _flat(cls.body) if isinstance(node, _ASSIGNS)
            for t in _targets(node)}


def _inherited(mods, mod, cls: ast.ClassDef, depth: int = 0):
    """Methods and attributes of ``cls`` and of its bases in the
    package."""
    meths, attrs = _members(cls)
    for b in cls.bases:
        name = b.id if isinstance(b, ast.Name) else \
            b.attr if isinstance(b, ast.Attribute) else None
        r = _resolve(mods, mod.name, name) if name and depth < 8 else None
        if r is not None and isinstance(r[1], ast.ClassDef):
            bm, ba = _inherited(mods, r[0], r[1], depth + 1)
            for k, v in bm.items():
                meths.setdefault(k, v)
            attrs |= ba
    return meths, attrs


def _port_name(jax_rel: str) -> str:
    rel = RENAMED.get(jax_rel, jax_rel)
    parts = Path(rel).with_suffix("").parts
    parts = parts[:-1] if parts[-1] == "__init__" else parts
    return ".".join(("alluxio_tpu_torch",) + parts)


def _jax_name(jax_rel: str) -> str:
    parts = Path(jax_rel).with_suffix("").parts
    parts = parts[:-1] if parts[-1] == "__init__" else parts
    return ".".join(("alluxio_tpu",) + parts)


def gaps(jmods, pmods, jax_rel: str) -> List[str]:
    """What the port lacks of the JAX module at ``jax_rel``."""
    jm = jmods[_jax_name(jax_rel)]
    pm = pmods.get(_port_name(jax_rel))
    if pm is None:
        return ["<module>"]
    out = []
    for name in sorted(jm.public_names()):
        if name not in pm.bound | pm.exported:
            out.append(name)
            continue
        jr = _resolve(jmods, jm.name, name)
        pr = _resolve(pmods, pm.name, name)
        if jr is None or pr is None or jr[0] is not jm:
            continue  # a re-export is compared in its own module
        jn, pn = jr[1], pr[1]
        if isinstance(jn, _FUNCS) and isinstance(pn, _FUNCS):
            have = _params(pn)
            out += [f"{name}({p})" for p in _params(jn) if p not in have]
        elif isinstance(jn, ast.ClassDef) and isinstance(pn, ast.ClassDef):
            jmeths, _ = _members(jn)
            pmeths, pattrs = _inherited(pmods, pr[0], pn)
            for meth, node in sorted(jmeths.items()):
                if not (_public(meth) or meth in ("__init__", "__call__")):
                    continue
                if meth not in pmeths:
                    if meth != "__init__" and meth not in pattrs:
                        out.append(f"{name}.{meth}")
                    continue
                have = _params(pmeths[meth])
                out += [f"{name}.{meth}({p})" for p in _params(node)
                        if p not in have]
            out += [f"{name}.{a}" for a in sorted(_class_attr_names(jn))
                    if _public(a) and a not in pattrs and a not in pmeths]
    return out


_JMODS = load(JAX)
_PMODS = load(PORT)
JAX_FILES = sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))


@pytest.mark.parametrize("jax_rel", JAX_FILES)
def test_port_has_the_jax_modules_surface(jax_rel):
    found = set(gaps(_JMODS, _PMODS, jax_rel))
    allowed = {k.split("::", 1)[1] for k in ALLOWLIST
               if k.split("::", 1)[0] == jax_rel}
    assert sorted(found - allowed) == [], \
        f"{jax_rel}: missing in the port and not allowlisted"
    assert sorted(allowed - found) == [], \
        f"{jax_rel}: stale allowlist entries (the port has them now, " \
        f"or the JAX package no longer has them)"


def test_allowlist_entries_name_jax_files_and_port_tests():
    """Every entry names a JAX file, gives a reason, and its pin (when
    it has one) is a test that exists."""
    for key, (reason, pin) in ALLOWLIST.items():
        rel, _, gap = key.partition("::")
        assert rel in JAX_FILES and gap, key
        assert reason.strip(), key
        if pin is None:
            continue
        path, *names = pin.split("::")
        src = (ROOT / path).read_text()
        assert re.search(rf"^\s*def {names[-1]}\(", src, re.M), pin
        if len(names) == 2:
            assert re.search(rf"^class {names[0]}\b", src, re.M), pin


# -- the comparison on a seeded pair of packages ------------------------------
_JAX_SRC = {
    "__init__.py": "from alluxio_tpu.a import f, K\n"
                   "_LAZY = {'C': 'alluxio_tpu.a'}\n",
    "a.py": "K = 1\n_P = 2\n"
            "def f(x, *, y=0, z=1): pass\n"
            "class C:\n"
            "    MODE = 'x'\n"
            "    def __init__(self, a, b): pass\n"
            "    def m(self, q): pass\n"
            "    def _private(self): pass\n"
            "    @property\n"
            "    def p(self): return 1\n"
            "def g(): pass\n",
}
_PORT_SRC = {
    "__init__.py": "from alluxio_tpu_torch.a import f\n",
    "a.py": "class Base:\n"
            "    def m(self, q, **kwargs): pass\n"
            "class C(Base):\n"
            "    def __init__(self, a, **kw):\n"
            "        self.p = 1\n"
            "def f(x, **kwargs): pass\n",
}


@pytest.mark.parametrize("module,want", [
    ("__init__.py", ["C", "K"]),
    ("a.py", ["C.MODE", "C.__init__(b)", "K", "f(y)", "f(z)", "g"]),
])
def test_the_comparison_finds_what_a_seeded_port_lacks(tmp_path, module,
                                                        want):
    """A seeded port that lacks a re-export, a constant, a function, a
    class attribute and parameters (``**kwargs`` standing in for them)
    is caught; an inherited method and an attribute set on ``self`` in
    place of a property are not."""
    for pkg, files in (("alluxio_tpu", _JAX_SRC),
                       ("alluxio_tpu_torch", _PORT_SRC)):
        (tmp_path / pkg).mkdir()
        for name, src in files.items():
            (tmp_path / pkg / name).write_text(src)
    jmods = load(tmp_path / "alluxio_tpu")
    pmods = load(tmp_path / "alluxio_tpu_torch")
    assert sorted(gaps(jmods, pmods, module)) == want
