"""zenlint's source layer: AST rules holding the port to the registry
contract (the port's copy of ``repro.analysis.ast_rules``).

  AST1  no raw ``torch.distributed`` collective (``all_reduce``,
        ``all_gather*``, ``all_to_all*``, ``reduce_scatter*``,
        ``broadcast``, send / recv, ...) outside the group classes:
        ``core/schemes.py``'s ``SimGroup`` / ``DistGroup``, where every
        scheme's wire op runs (so ``SyncStats``, the cost model and R2
        see it), ``launch/mesh.py``, and the model axis's ``ShardCtx`` in
        ``models/common.py`` (tensor parallelism: a different subsystem,
        as the reference exempts its mesh-structure axes).
  AST2  no scheme-name string comparisons (``if scheme == "zen"``)
        outside the registry surfaces: dispatch chains must not regrow.
  AST3  no hardcoded CLI ``choices=[...]`` containing scheme names:
        derive them from ``registry.cli_scheme_choices()``.

A line can waive a finding with a ``# zenlint: ignore[ASTn]`` comment,
which carries its reason on the same line: grep-able, reviewed, never
silent.
"""
from __future__ import annotations

import ast
import os
import re

from repro_torch.analysis.rules import Finding

SYNC_COLLECTIVES = frozenset({
    "all_reduce", "all_gather", "all_gather_into_tensor",
    "all_gather_single", "all_gather_object", "all_to_all",
    "all_to_all_single", "reduce_scatter", "reduce_scatter_tensor",
    "broadcast", "broadcast_object_list", "reduce", "gather", "scatter",
    "send", "recv", "isend", "irecv", "batch_isend_irecv",
})

# files allowed to call torch.distributed collectives (repo-relative)
COLLECTIVE_ALLOWED = ("src/repro_torch/core/schemes.py",
                      "src/repro_torch/launch/mesh.py",
                      "src/repro_torch/models/common.py")

# files allowed to compare scheme-name literals: the registry and the core
# surfaces whose registration or bucketing is keyed by name
LITERAL_ALLOWED = (
    "src/repro_torch/core/registry.py",
    "src/repro_torch/core/costmodel.py",
    "src/repro_torch/core/schemes.py",
    "src/repro_torch/core/zen.py",
    "src/repro_torch/core/buckets.py",
)

_WAIVER = re.compile(r"#\s*zenlint:\s*ignore\[(AST\d)\]")


def _scheme_names() -> frozenset:
    from repro_torch.core import registry
    return frozenset(registry.registered_schemes())


def _is_dist(node: ast.AST) -> bool:
    """``dist`` or ``torch.distributed`` (the module's usual names)."""
    if isinstance(node, ast.Name):
        return node.id == "dist"
    return isinstance(node, ast.Attribute) and node.attr == "distributed"


def _call_collective(node: ast.Call) -> str | None:
    """The torch.distributed collective a call invokes, if any."""
    f = node.func
    if isinstance(f, ast.Attribute) and f.attr in SYNC_COLLECTIVES \
            and _is_dist(f.value):
        return f.attr
    return None


def _waived(lines: list[str], lineno: int, rid: str) -> bool:
    line = lines[lineno - 1] if 0 < lineno <= len(lines) else ""
    return any(m == rid for m in _WAIVER.findall(line))


def _const_scheme_strs(node: ast.AST, names: frozenset) -> list[str]:
    """Scheme-name string constants inside a literal (str or container)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [node.value] if node.value in names else []
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        out = []
        for elt in node.elts:
            out.extend(_const_scheme_strs(elt, names))
        return out
    return []


def check_source(src: str, relpath: str) -> list[Finding]:
    """Run AST1-AST3 on one file's source; ``relpath`` decides the
    allowlists."""
    names = _scheme_names()
    findings: list[Finding] = []
    lines = src.splitlines()
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        return [Finding("AST1", f"unparsable: {e}", case=relpath)]
    coll_ok = relpath.startswith(COLLECTIVE_ALLOWED)
    lit_ok = relpath.startswith(LITERAL_ALLOWED)
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            cname = _call_collective(node)
            if cname and not coll_ok \
                    and not _waived(lines, node.lineno, "AST1"):
                findings.append(Finding(
                    "AST1",
                    f"raw collective dist.{cname}() outside the group "
                    f"classes: run it through a SimGroup / DistGroup so "
                    f"SyncStats and the wire contract (R2) see it",
                    case=f"{relpath}:{node.lineno}"))
            for kw in node.keywords:
                if kw.arg == "choices":
                    hits = _const_scheme_strs(kw.value, names)
                    if hits and not _waived(lines, node.lineno, "AST3"):
                        findings.append(Finding(
                            "AST3",
                            f"hardcoded CLI choices with scheme name(s) "
                            f"{sorted(set(hits))}: derive them from "
                            f"registry.cli_scheme_choices()",
                            case=f"{relpath}:{node.lineno}"))
        elif isinstance(node, ast.Compare) and not lit_ok:
            sides = [node.left, *node.comparators]
            hits, other_src = [], []
            for s in sides:
                got = _const_scheme_strs(s, names)
                hits.extend(got)
                if not got:
                    other_src.append(ast.unparse(s))
            # "dense" doubles as an architecture kind (models/): the bare
            # word only counts when the compared expression looks
            # scheme-ish; distinctive names (zen, agsparse, ...) always do
            if set(hits) <= {"dense"} and not re.search(
                    r"scheme|sync|plan", " ".join(other_src)):
                hits = []
            if hits and not _waived(lines, node.lineno, "AST2"):
                findings.append(Finding(
                    "AST2",
                    f"scheme-name literal comparison against "
                    f"{sorted(set(hits))}: dispatch through the registry "
                    f"(SchemeSpec), not string chains",
                    case=f"{relpath}:{node.lineno}"))
    return findings


def run_tree(root: str = "src/repro_torch") -> list[Finding]:
    """Lint every Python file under ``root``; the allowlists match paths
    relative to the working directory (the repo's root)."""
    findings: list[Finding] = []
    for dirpath, dirs, files in os.walk(root):
        dirs.sort()
        for fn in sorted(files):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path).replace(os.sep, "/")
            with open(path) as f:
                findings.extend(check_source(f.read(), rel))
    return findings
